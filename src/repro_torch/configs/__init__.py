from repro_torch.configs.registry import ARCH_IDS, canon, get, get_smoke, swa_variant
from repro_torch.configs.shapes import INPUT_SHAPES, InputSpec, input_specs

__all__ = ["ARCH_IDS", "canon", "get", "get_smoke", "swa_variant", "INPUT_SHAPES", "InputSpec",
           "input_specs"]
