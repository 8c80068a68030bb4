"""Architecture and input-shape configurations of the LM stack (the port
of ``repro.configs``); only the families already ported have a config
module here."""
from repro_torch.configs.base import (ARCH_IDS, ArchConfig, MoESpec, SSMSpec,
                                      ShapeConfig, get_arch)
