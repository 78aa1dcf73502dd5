"""Dense decoder model of the port (see ``repro.models`` for the
reference)."""
from repro_torch.models.config import ModelConfig  # noqa: F401
