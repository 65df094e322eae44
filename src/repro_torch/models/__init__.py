from repro_torch.models.model import LM  # noqa: F401
