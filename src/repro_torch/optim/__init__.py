from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa: F401
from repro_torch.optim.grad_compress import (  # noqa: F401
    compress_int8,
    decompress_int8,
    error_feedback_update,
)
