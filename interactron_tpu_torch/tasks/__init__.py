from interactron_tpu_torch.tasks.detr_task import DETRTask
from interactron_tpu_torch.tasks.interactron import InteractronRandomTask, InteractronTask
from interactron_tpu_torch.tasks.multiframe import MultiFrameTask

__all__ = ["DETRTask", "InteractronRandomTask", "InteractronTask", "MultiFrameTask"]
