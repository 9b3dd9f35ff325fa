from repro_torch.configs.registry import ARCH_IDS, canon, get, get_smoke, swa_variant

__all__ = ["ARCH_IDS", "canon", "get", "get_smoke", "swa_variant"]
