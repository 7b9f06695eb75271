from repro_torch.configs.base import ArchConfig  # noqa: F401
