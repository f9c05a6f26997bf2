"""Host utilities of the port (structured metrics logging)."""
from asr_craft_tpu_torch.utils.logging import MetricsLogger
