from .pipeline import (AMDCrossVideoPipeline, AMDDiffMotionPipeline,
                       AMDReconstructionPipeline, GTMotionAblationPipeline,
                       reconstruct_clip)

__all__ = ["AMDCrossVideoPipeline", "AMDDiffMotionPipeline",
           "AMDReconstructionPipeline", "GTMotionAblationPipeline",
           "reconstruct_clip"]
