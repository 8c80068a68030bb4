"""Architecture and input-shape configurations of the LM stack (the port
of ``repro.configs``), one config module per architecture."""
from repro_torch.configs.base import (ARCH_IDS, ArchConfig, MoESpec, SSMSpec,
                                      ShapeConfig, get_arch)
