"""Training entry point, restart-safe, on one device or a ``DeviceMesh``.

The JAX package's ``launch/train.py``: any arch, a deterministic token
stream, periodic async checkpoints, and resumption from the latest one.
Where the JAX driver feeds an audio or vision model zero frames or
patches, this one draws them from a seed per step (``stub_frontend``):
zeros overflow the gradient of a deep encoder or VLM to NaN.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --steps 20 --batch 8 --seq 128 --device cpu          # reduced, CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
      --full --steps 4 --batch 4 --seq 4096 --microbatches 2   # the card
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --tp 2 --steps 4 --device cpu           # tensor parallel, 2 ranks

On the card every kernel of the train path runs forward and backward as a
hand-written kernel: the prefill attention (``kernels/flash_attention``),
the MoE grouped matmul (``kernels/moe_gmm``) and the RG-LRU scan
(``kernels/rglru_scan``); on the CPU their plain versions.  On a mesh
(``tp != 1``, a world of several ranks, or a ``mesh`` given) parameters and
optimizer state are DTensors placed by ``ShardingPolicy`` and the step runs
under its activation policy; each kernel runs on its rank's shard
(``distributed/api.py``).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import configs as cfglib
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import TokenPipeline
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_train_step, default_optimizer
from repro_torch.models import lm
from repro_torch.models.config import ShapeSpec


FRONTEND_SEED = 1 << 20  # stub frontends of step i draw from seed + i


def stub_frontend(cfg, batch: int, seq: int, step: int,
                  device) -> torch.Tensor:
    """The stub modality input of step ``step``: ``seq`` audio frames or
    ``cfg.frontend_len`` vision patches a row, (batch, n, d_model) standard
    normal draws seeded by the step (a resumed run draws the same), in the
    activation dtype.  The JAX driver feeds zeros; at a zero input every
    ``rms_norm`` passes its gradient on times rsqrt(eps) = 1000, so through
    SeamlessM4T-medium's 12 encoder layers, or LLaVA-NeXT-34B's 60 decoder
    layers over zero patch rows, the gradient overflows to NaN in both
    packages (at the reduced widths from 8 encoder or 16 decoder
    layers)."""
    n = seq if cfg.frontend == "audio" else cfg.frontend_len
    gen = torch.Generator(device=device)
    gen.manual_seed(FRONTEND_SEED + step)
    return torch.randn((batch, n, cfg.d_model), generator=gen,
                       device=device).to(cfg.activation_dtype)


def train(arch: str, *, reduced: bool = True, steps: int = 20, batch: int = 8,
          seq: int = 128, ckpt_dir: str = "", ckpt_every: int = 10,
          tp: int = 1, mesh=None, log_every: int = 5, microbatches: int = 1,
          device="cuda",
          on_step: Optional[Callable[[int, dict], None]] = None) -> list:
    """Train ``arch`` for ``steps`` steps from random weights of seed 0 (or
    from the latest checkpoint under ``ckpt_dir``) on the token pipeline's
    batches and, for a model with a frontend, ``stub_frontend``'s; the
    loss of every step run.  ``on_step(i, metrics)``, if given, receives
    each step's metrics as floats, with ``step_s``, the step's wall time
    up to its loss on the host.

    Sharding: on ``mesh`` when one is given; else, when ``tp != 1`` or the
    initialized world has several ranks, on ``make_host_mesh(tp)`` over
    that world (every rank calls ``train`` alike).  With a world of one
    and no mesh the step runs on plain tensors."""
    dev = resolve_device(device)
    if mesh is None and (tp != 1 or (dist.is_initialized()
                                     and dist.get_world_size() > 1)):
        mesh = make_host_mesh(tp, device=dev.type)
    policy = ShardingPolicy(mesh) if mesh is not None else None
    cfg = cfglib.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("custom", seq, batch, "train")
    optimizer = default_optimizer(cfg)
    step_fn = build_train_step(cfg, optimizer=optimizer, shape=shape,
                               microbatches=microbatches, policy=policy)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init_params(gen, cfg)
    opt_state = optimizer.init(params)
    if policy is not None:  # the same seed on every rank: place its shards
        p_spec = policy.param_pspecs(cfg, params)
        o_spec = policy.opt_pspecs(optimizer.name, p_spec, params)
        params = policy.distribute(params, p_spec)
        opt_state = policy.distribute(opt_state, o_spec)
    step = 0
    talk = not dist.is_initialized() or dist.get_rank() == 0

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start, (params, opt_state) = ckpt.restore((params, opt_state))
        step = start
        if talk:
            print(f"resumed from step {start}")

    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch)
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        ts = time.perf_counter()
        host = {k: torch.from_numpy(v).long().to(dev)
                for k, v in pipe.batch_at(i).items()}
        if cfg.frontend:
            host["frontend"] = stub_frontend(cfg, batch, seq, i, dev)
        params, opt_state, step, metrics = step_fn(params, opt_state, step,
                                                   host)
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(i, {**{k: float(v) for k, v in metrics.items()},
                        "step_s": time.perf_counter() - ts})
        if (i + 1) % log_every == 0 and talk:
            dt = (time.time() - t0) / max(i + 1 - start, 1)
            print(f"step {i+1}: loss={losses[-1]:.4f} ({dt*1e3:.0f} ms/step)")
        if ckpt and (i + 1) % ckpt_every == 0:
            ckpt.save_async(i + 1, (params, opt_state))
    if ckpt:
        if start < steps and steps % ckpt_every:
            ckpt.save(steps, (params, opt_state))
        ckpt.wait()  # else the last periodic save holds step `steps`
    pipe.close()
    return losses


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if "WORLD_SIZE" in os.environ:  # started by torchrun: one rank each
        if resolve_device(args.device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(
            "nccl" if args.device == "cuda" else "gloo")
    losses = train(args.arch, reduced=args.reduced, steps=args.steps,
                   batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                   tp=args.tp, microbatches=args.microbatches,
                   device=args.device)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
