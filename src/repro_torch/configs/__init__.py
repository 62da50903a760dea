from repro_torch.configs.registry import ARCHS, get, list_archs  # noqa: F401
