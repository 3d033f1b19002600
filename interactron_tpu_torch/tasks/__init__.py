from interactron_tpu_torch.tasks.interactron import InteractronRandomTask, InteractronTask

__all__ = ["InteractronRandomTask", "InteractronTask"]
