"""The dry run on one card: every (arch × shape) step over fake tensors,
with its peak device memory and its FLOPs (the port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all

needs no card and allocates nothing.  For each combination it

1. builds, under ``FakeTensorMode``, the full-width parameters
   (``init_params`` on the CPU: a generator cannot live on the meta
   device), AdamW's state (``adamw_init``), the batch
   (``configs.inputs.make_batch``) and a decode step's cache
   (``init_cache``), of one data shard of the shape's global batch:
   ``max(1, global_batch // (data_shards · pods))`` of
   ``make_production_mesh``, the q = 16 parties its model axis;
2. runs the port's own step on them: ``launch.train.train_step`` with
   ``adamw_update`` (the plain routes, ``remat`` on), ``models.model.
   prefill`` or ``decode_step`` (the kernel routes, whose wrappers take
   their fake route: ``kernels.ops``);
3. records the step's memory as the card's caching allocator would see
   it (``MemoryTracker``), its FLOPs (``torch.utils.flop_counter`` for
   the aten operations, ``ops.FAKE_TALLY`` for the kernels), the bytes
   its operations read and write, the analytic model FLOPs and parameter
   counts (``launch.hlo_analysis``) and the roofline;
4. writes a JSON record under ``results/dryrun_torch/``.

The record keeps the reference's keys where they have a meaning on one
card: ``memory`` (``argument_bytes``: the parameters, optimiser state,
batch and cache, live at entry; ``output_bytes``: the storages the step
returns that are not arguments; ``peak_bytes``; ``temp_bytes`` = peak −
arguments), ``flops_per_device``, ``bytes_accessed_per_device``,
``model_flops``, ``param_count``, ``roofline``, ``fits`` (the peak within
80 GB, or within the card's memory where one is present) and ``status``.
There is no lowering or compiling, so ``lower_s`` and ``compile_s`` go
(``host_seconds`` is the fake pass's own time), and there are no
collectives on one card, so ``collectives`` goes.  ``--cache-seq-axes``
goes too: the port's decode cache is one tensor on one card, its
sequence axis seen as q shards (``sharding.api``).  So does
``--seq-parallel``: ``Runtime.seq_parallel_norms`` is a sharding
annotation that changes nothing on one card (``models.model``).
``--cast-bf16`` keeps its meaning, the loss reading every f32 leaf cast
to bf16 once, up front (the gradients are the f32 leaves'), though its
reason in the reference (bf16 FSDP all-gathers) has none here.

``--unroll n`` runs the tree cut to n layers (a period stack: n periods;
an encoder: min(n, enc_layers) layers), as the reference's
``_unrolled_cfg``, through ``Runtime(unroll_layers=n)``, and also the tree
of n + 1: the record's ``extrapolated`` gives the full depth's peak,
FLOPs and bytes as the n-unit values plus the per-unit difference times
the units left.  It is the answer to the plain scan's Python loop, which
makes some 10⁵ fake operations a mamba layer at 16 × 4,096 tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeConfig, get_arch
from repro_torch.configs.inputs import make_batch
from repro_torch.core.secure_agg import mask_generator
from repro_torch.kernels import ops
from repro_torch.launch import hlo_analysis
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.optim.tree import leaves, tree_map, unflatten
from repro_torch.sharding.api import Runtime

BLOCK = 512                    # the CUDA caching allocator's rounding
CARD_BYTES = 80e9              # an H100 80GB, where no card is present
SEED = 0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _block(nbytes: int) -> int:
    return -(-nbytes // BLOCK) * BLOCK


class MemoryTracker(TorchDispatchMode):
    """Live device bytes as the caching allocator counts them, on real or
    fake tensors: one entry per storage (a view adds nothing), its bytes
    rounded up to the allocator's 512-byte block, freed when the storage
    dies (a weakref finalizer).  ``track`` counts storages made outside
    (the step's arguments) as live; every storage an operation returns is
    counted when it returns, so ``peak`` is the most that was live after
    any operation.  ``accessed`` sums the bytes every operation that
    returns a tensor and is not a view reads and writes: what an eager
    step moves through HBM where no operation finds its inputs in a
    cache."""

    def __init__(self):
        super().__init__()
        self.live, self._fin = {}, {}
        self.current = self.peak = self.accessed = 0

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        self.live[key] = n = _block(st.nbytes())
        self.current += n
        self._fin[key] = weakref.finalize(st, MemoryTracker._free,
                                          weakref.ref(self), key)

    @staticmethod
    def _free(ref, key) -> None:
        self = ref()
        if self is not None and key in self.live:
            self.current -= self.live.pop(key)
            del self._fin[key]

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live; returns their
        bytes."""
        for t in _tensors(tree):
            self._add(t)
        self.peak = max(self.peak, self.current)
        return self.storage_bytes(tree)

    def storage_bytes(self, tree, exclude=()) -> int:
        """Bytes of the distinct storages of ``tree``, less those of
        ``exclude``'s."""
        skip = {id(t.untyped_storage()) for t in _tensors(exclude)}
        seen = {}
        for t in _tensors(tree):
            st = t.untyped_storage()
            if id(st) not in skip:
                seen[id(st)] = _block(st.nbytes())
        return sum(seen.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        for t in outs:
            self._add(t)
        self.peak = max(self.peak, self.current)
        if outs and not func.is_view:       # not a view or a query
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in _tensors((args, kwargs)) + outs)
        return out

    def __exit__(self, *exc):
        for fin in self._fin.values():
            fin.detach()
        return super().__exit__(*exc)


@dataclasses.dataclass
class StepCost:
    """What ``measure`` saw of one step."""

    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    aten_flops: int
    kernel_flops: float
    kernel_bytes: int
    accessed_bytes: int
    kernel_launches: dict

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    @property
    def hbm_bytes(self) -> int:
        return self.accessed_bytes + self.kernel_bytes


def measure(step, args) -> StepCost:
    """Run ``step(*args)`` once under a ``MemoryTracker`` and a
    ``FlopCounterMode``, the tensors of ``args`` live at entry.  Real
    tensors run; under a ``FakeTensorMode`` nothing is allocated."""
    with ops.fake_kernels() as tally, FlopCounterMode(display=False) as fc, \
            MemoryTracker() as mt:
        arg_bytes = mt.track(args)
        out = step(*args)
        out_bytes = mt.storage_bytes(out, exclude=args)
    return StepCost(arg_bytes, out_bytes, mt.peak, fc.get_total_flops(),
                    sum(tally.flops.values()), sum(tally.bytes.values()),
                    mt.accessed, dict(tally.launches))


def _unrolled_cfg(cfg, n: int):
    """The tree cut to ``n`` layers (``n`` periods for a period stack),
    the encoder to min(enc_layers, n), as the reference's."""
    if cfg.period is not None:
        return dataclasses.replace(cfg, n_layers=n * len(cfg.period))
    return dataclasses.replace(cfg, n_layers=n,
                               enc_layers=min(cfg.enc_layers, n))


def card_batch(shape: ShapeConfig, multi_pod: bool = False) -> int:
    """One data shard of ``shape``'s global batch on the production mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    return max(1, shape.global_batch // (mesh.data_shards * (mesh.pods or 1)))


def build_step(cfg, shape: ShapeConfig, rt: Runtime, *,
               serve_weights: str = "fsdp", cast_bf16: bool = False,
               device="cpu"):
    """(step, args) of ``shape.mode`` on ``device``, the arguments made
    from the seed: ``train`` → ``launch.train.train_step`` with AdamW
    (lr 3e-4) on (params, opt, batch, gen), with ``cast_bf16`` the same
    step written out, its loss reading every f32 leaf cast to bf16;
    ``prefill`` → ``models.model.prefill`` under no_grad on (params,
    batch, gen);
    ``decode`` → ``decode_step`` under no_grad, its batch's cache built
    by ``make_batch``; with ``serve_weights="replicated_bf16"`` its
    weights are bf16.  Call it under a ``FakeTensorMode`` to allocate
    nothing."""
    params = model_lib.init_params(cfg, SEED, device=device)
    gen = mask_generator(SEED, 0, device=device)
    batch = make_batch(cfg, shape, rt, SEED, device=device)
    if shape.mode == "train":
        opt, update = train_lib.make_optimizer("adamw", params, 3e-4)

        def train(params, opt, batch, gen):
            if not cast_bf16:
                return train_lib.train_step(rt, cfg, params, opt, batch,
                                            gen, update)
            flat = [p.detach().requires_grad_() for p in leaves(params)]
            cast = [p.to(torch.bfloat16) if p.dtype == torch.float32
                    else p for p in flat]
            loss = model_lib.train_loss(
                rt, cfg, unflatten(params, iter(cast)), batch, gen)
            grads = unflatten(params, iter(torch.autograd.grad(loss, flat)))
            params, opt = update(params, grads, opt)
            return loss.detach(), params, opt
        return train, (params, opt, batch, gen)
    if shape.mode == "decode" and serve_weights == "replicated_bf16":
        params = tree_map(lambda a: a.to(torch.bfloat16), params)
    fn = model_lib.prefill if shape.mode == "prefill" \
        else model_lib.decode_step

    @torch.no_grad()
    def serve(params, batch, gen):
        return fn(rt, cfg, params, batch, gen)
    return serve, (params, batch, gen)


def counted_params(cfg) -> int:
    """Elements of ``init_params(cfg)``'s tree, built over fake tensors."""
    with FakeTensorMode():
        params = model_lib.init_params(cfg, SEED, device="cpu")
        return sum(t.numel() for t in _tensors(params))


def _fake_cost(cfg, shape, rt, **kw) -> StepCost:
    with FakeTensorMode():
        step, args = build_step(cfg, shape, rt, **kw)
        return measure(step, args)


def _card_bytes() -> float:
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return CARD_BYTES


def _cost_dict(c: StepCost) -> dict:
    return {"memory": {"argument_bytes": c.argument_bytes,
                       "output_bytes": c.output_bytes,
                       "temp_bytes": c.temp_bytes,
                       "peak_bytes": c.peak_bytes},
            "flops_per_device": c.flops, "flops_aten": c.aten_flops,
            "flops_kernels": c.kernel_flops,
            "bytes_accessed_per_device": c.hbm_bytes,
            "kernel_launches": c.kernel_launches}


def run_one(arch_id: str, shape_name: str, multi_pod: bool = False,
            unroll=None, out_dir: str = "results/dryrun_torch",
            quiet: bool = False, secure_mode: str = "two_tree",
            moe_dispatch: str = "replicated", serve_weights: str = "fsdp",
            cast_bf16: bool = False, batch=None) -> dict:
    """One combination's record (written to ``out_dir`` where given)."""
    full = get_arch(arch_id)
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not full.supports_long:
        return {"arch": arch_id, "shape": shape_name,
                "status": "skipped (full attention; no sub-quadratic decode "
                          "path)"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    b = card_batch(shape, multi_pod) if batch is None else int(batch)
    card = ShapeConfig(shape.name, shape.seq_len, b, shape.mode)
    rt = Runtime(model_size=mesh.q, secure_mode=secure_mode,
                 moe_dispatch=moe_dispatch, unroll_layers=unroll)
    if shape.mode == "train":
        rt = dataclasses.replace(rt, scan_impl="reference",
                                 attn_impl="reference")
    rec = {"arch": arch_id, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "q": mesh.q,
           "batch": b, "seq_len": shape.seq_len, "mode": shape.mode,
           "unroll": unroll, "secure_mode": secure_mode,
           "moe_dispatch": moe_dispatch, "serve_weights": serve_weights,
           "cast_bf16": cast_bf16}
    kw = dict(serve_weights=serve_weights, cast_bf16=cast_bf16)
    t0 = time.time()
    if unroll is None:
        cost = _fake_cost(full, card, rt, **kw)
        rec.update(_cost_dict(cost))
        final = cost
    else:
        cost = _fake_cost(_unrolled_cfg(full, unroll), card, rt, **kw)
        nxt = _fake_cost(_unrolled_cfg(full, unroll + 1), card,
                         dataclasses.replace(rt, unroll_layers=unroll + 1),
                         **kw)
        units = full.n_layers // (len(full.period) if full.period else 1)
        rec.update(_cost_dict(cost))
        rec["next_unit"] = _cost_dict(nxt)

        def extra(a, b_):
            return a + (units - unroll) * (b_ - a)
        launches = {k: extra(cost.kernel_launches.get(k, 0),
                             nxt.kernel_launches.get(k, 0))
                    for k in set(cost.kernel_launches)
                    | set(nxt.kernel_launches)}
        final = StepCost(**{
            f.name: extra(getattr(cost, f.name), getattr(nxt, f.name))
            for f in dataclasses.fields(StepCost)
            if f.name != "kernel_launches"}, kernel_launches=launches)
        rec["extrapolated"] = dict(units=units, **_cost_dict(final))
    rec["host_seconds"] = time.time() - t0
    rec["model_flops"] = hlo_analysis.model_flops(full, card)
    rec["param_count"] = hlo_analysis.param_count(full)
    rec["active_param_count"] = hlo_analysis.active_param_count(full)
    rec["counted_params"] = counted_params(full)
    rec["roofline"] = hlo_analysis.Roofline(
        final.flops, final.hbm_bytes, rec["model_flops"]).to_dict()
    rec["card_bytes"] = _card_bytes()
    rec["fits"] = final.peak_bytes <= rec["card_bytes"]
    rec["status"] = "ok"
    if not quiet:
        print(f"== {arch_id} × {shape_name} × {rec['mesh']} batch {b}"
              f"{' unroll=' + str(unroll) if unroll else ''} ==")
        print(f"peak {final.peak_bytes / 1e9:.2f} GB (fits "
              f"{rec['fits']}), flops {final.flops:.4e} (aten "
              f"{final.aten_flops:.4e}, kernels {final.kernel_flops:.4e}), "
              f"model {rec['model_flops']:.4e}, {rec['host_seconds']:.1f} s")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch_id}_{shape_name}_{rec['mesh']}" + \
            (f"_unroll{unroll}" if unroll else "") + \
            ("_ring" if secure_mode == "ring_masks" else "") + \
            ("_a2a" if moe_dispatch == "alltoall" else "") + \
            ("_repw" if serve_weights == "replicated_bf16" else "") + \
            ("_bf16" if cast_bf16 else "") + \
            (f"_b{batch}" if batch is not None else "")
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=list(SHAPES) + ["all"])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"],
                    help="the production mesh whose data shard is the "
                         "per-card batch")
    ap.add_argument("--unroll", type=int, default=None)
    ap.add_argument("--secure-mode", default="two_tree",
                    choices=["two_tree", "ring_masks"])
    ap.add_argument("--moe-dispatch", default="replicated",
                    choices=["replicated", "alltoall"])
    ap.add_argument("--serve-weights", default="fsdp",
                    choices=["fsdp", "replicated_bf16"])
    ap.add_argument("--cast-bf16", action="store_true")
    ap.add_argument("--batch", type=int, default=None,
                    help="the per-card batch (default: one data shard)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_one(arch, shape, mp, args.unroll, args.out,
                                  secure_mode=args.secure_mode,
                                  moe_dispatch=args.moe_dispatch,
                                  serve_weights=args.serve_weights,
                                  cast_bf16=args.cast_bf16, batch=args.batch)
                    if rec["status"].startswith("skipped"):
                        print(f"-- {arch} × {shape}: {rec['status']}")
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete: every combination ran over fake tensors.")


if __name__ == "__main__":
    main()
