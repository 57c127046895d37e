from .pipeline import (AMDCrossVideoPipeline, AMDDiffMotionPipeline,
                       AMDReconstructionPipeline, GTMotionAblationPipeline,
                       ImageAudio2VideoPipeline, reconstruct_clip)

__all__ = ["AMDCrossVideoPipeline", "AMDDiffMotionPipeline",
           "AMDReconstructionPipeline", "GTMotionAblationPipeline",
           "ImageAudio2VideoPipeline", "reconstruct_clip"]
