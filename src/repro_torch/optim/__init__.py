"""Optimisers of LM training (the port of ``repro.optim``): AdamW, VFB²'s
bounded-staleness SGD and the SVRG helpers, over parameter dicts."""
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.delayed import delayed_init, delayed_update
from repro_torch.optim.svrg import svrg_direction, svrg_snapshot

__all__ = ["adamw_init", "adamw_update", "delayed_init", "delayed_update",
           "svrg_direction", "svrg_snapshot"]
