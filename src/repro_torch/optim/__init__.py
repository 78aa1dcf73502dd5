"""Optimizer of the port: the reference's functional AdamW and LR
schedules (``repro.optim``) on nested dicts of tensors."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_apply,  # noqa: F401
                                     adamw_init, global_norm)
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         wsd_schedule)
