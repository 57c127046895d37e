from .pipeline import AMDReconstructionPipeline, reconstruct_clip

__all__ = ["AMDReconstructionPipeline", "reconstruct_clip"]
