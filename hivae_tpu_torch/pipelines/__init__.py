from .pipeline import (AMDCrossVideoPipeline, AMDReconstructionPipeline,
                       GTMotionAblationPipeline, reconstruct_clip)

__all__ = ["AMDCrossVideoPipeline", "AMDReconstructionPipeline",
           "GTMotionAblationPipeline", "reconstruct_clip"]
