"""The reference's side of tests/test_torch_mesh.py: the same cases on
the reference's (2, 2) mesh over four forced host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_mesh_cases.py WORK

reads each case's parameters from WORK (the port wrote them in the
reference's layout), writes the final parameters of the train cases as
checkpoints under WORK/ref/<case> and every other result to
WORK/ref.npz."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _mesh_specs as SP  # noqa: E402
from repro.checkpoint import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_reduced_config, get_shape  # noqa: E402
from repro.data.pipeline import device_batch, host_batch  # noqa: E402
from repro.launch import steps as S  # noqa: E402
from repro.models import forward, init_params  # noqa: E402
from repro.optim import optimizer as O  # noqa: E402
from repro.parallel import make_ctx  # noqa: E402


def main(work: str) -> None:
    # the reference's make_test_mesh(2, 2), with the axes GSPMD-partitioned
    # (Auto): the installed JAX makes Explicit axes by default, under
    # which the reference's embedding gather does not resolve
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for name, spec in SP.ALL.items():
        cfg = SP.build(get_reduced_config, spec)
        ctx = make_ctx(cfg, mesh)
        params, _ = jax_ckpt.restore(
            os.path.join(work, SP.params_key(spec)), 0,
            init_params(jax.random.PRNGKey(0), cfg))
        if name in SP.TRAIN or name in SP.ADAFACTOR:
            shape = dataclasses.replace(get_shape("train_4k"),
                                        seq_len=SP.SEQ,
                                        global_batch=SP.BATCH)
            opt = O.init_opt_state(cfg.train, params)
            rows = []
            with mesh:
                step = S.make_train_step(ctx, cfg, donate=False)
                for i in range(2 if name in SP.TRAIN else 1):
                    params, opt, m = step(params, opt, device_batch(
                        ctx, host_batch(cfg, shape, i)))
                    rows.append([float(m["loss"]), float(m["grad_norm"])])
            out[f"{name}/metrics"] = np.array(rows)
            jax_ckpt.save(os.path.join(work, "ref", name), len(rows),
                          jax.tree.map(np.asarray, params))
            continue
        tokens, embeds = SP.inputs(name, cfg)
        with mesh:
            h, _, aux = jax.jit(lambda p, t, e: forward(
                ctx, cfg, p, tokens=t, embeds=e, mode="train"))(
                    params, None if tokens is None else jnp.asarray(tokens),
                    None if embeds is None else jnp.asarray(embeds))
        out[f"{name}/hidden"] = np.asarray(h, np.float32)
        out[f"{name}/aux"] = np.asarray(aux, np.float32)
    np.savez(os.path.join(work, "ref.npz"), **out)
    print("OK")


if __name__ == "__main__":
    main(sys.argv[1])
