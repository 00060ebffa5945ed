"""End-to-end training example of the PyTorch port: the ~100M-parameter
qwen3-family model of ``examples/train_ps_mode.py`` with parameter-server
(fsdp / ZeRO-3) weight sharding over a device mesh, and
checkpoint/restart.

    PYTHONPATH=src python examples/torch_train_ps_mode.py           # full
    PYTHONPATH=src python examples/torch_train_ps_mode.py --tiny    # smoke
    PYTHONPATH=src python examples/torch_train_ps_mode.py --tiny --device cpu

As in the JAX example, the weights are sharded over the data axis of a
(data, model) mesh and gathered at use (the pull; the gradients are
reduce-scattered back, the push). With ``--device cpu`` the mesh is
2 x 2 over four spawned gloo processes, the JAX example's (2, 2) host
mesh; on the card (the default) it is 1 x 1, one H100 on NCCL at world
size 1, with attention's forward in the hand-written flash kernel. The
model, the data, the checkpoints and the restart are the same.
"""
import argparse
import dataclasses
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import AttentionConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import init_single, spawn
from repro_torch.train.trainer import TrainerConfig, train_on_mesh


def run(acfg, shape, tcfg, device):
    """The Trainer over the mesh: rank 0's record."""
    if device == "cpu":
        return spawn(train_on_mesh, 4, acfg, shape, tcfg, DataConfig(seed=0),
                     (2, 2), "cpu")[0]
    init_single("cuda")
    try:
        return train_on_mesh(acfg, shape, tcfg, DataConfig(seed=0), (1, 1),
                             "cuda")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="small dims, 6 steps (a smoke run)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA GPU is visible; pass --device cpu")

    base = get_config("qwen3-8b")
    if args.tiny:
        model = dataclasses.replace(
            base.model, num_layers=2, d_model=64, d_ff=160, vocab_size=512,
            attention=AttentionConfig(n_heads=4, n_kv_heads=2, d_head=16))
        shape = ShapeSpec("tiny", seq_len=32, global_batch=4, kind="train")
        steps = 6
    else:
        # ~100M params: 10L, d=640, kv-grouped attention, 50k vocab
        model = dataclasses.replace(
            base.model, num_layers=10, d_model=640, d_ff=1920,
            vocab_size=50304,
            attention=AttentionConfig(n_heads=10, n_kv_heads=2, d_head=64))
        shape = ShapeSpec("train_100m", seq_len=512, global_batch=8,
                          kind="train")
        steps = 200

    acfg = base.replace(
        model=model,
        train=dataclasses.replace(base.train, param_dtype="float32",
                                  compute_dtype="float32",
                                  learning_rate=1e-3,
                                  use_flash_kernel=args.device == "cuda"),
        parallel=dataclasses.replace(base.parallel, fsdp=True, ps_mode=True))
    mesh = ("a 2x2 (data x model) mesh of 4 gloo CPU processes"
            if args.device == "cpu" else "a 1x1 mesh on one card (NCCL)")
    print(f"model: {acfg.model.num_params()/1e6:.1f}M params, PS(fsdp) mode "
          f"over {mesh}")

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ps_")
    tcfg = TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5,
                         log_every=1 if args.tiny else 10)
    tr = run(acfg, shape, tcfg, args.device)
    losses = [r.loss for r in tr.history]
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} "
          f"steps")

    # restart from checkpoint (fault-tolerance path)
    tr2 = run(acfg, shape, dataclasses.replace(tcfg, total_steps=steps + 2),
              args.device)
    print(f"resumed from step {tr2.history[0].step} after restart "
          f"(loss {tr2.history[-1].loss:.4f})")
    return tr, tr2


if __name__ == "__main__":
    main()
