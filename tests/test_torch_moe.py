"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the same parameters (the reference's ``init_moe``, through
numpy), fp32 on the CPU at atol/rtol 1e-4: the capacity, the dispatch
indices bit for bit on integer expert ids (ties are the point: the sort
must be stable), ``_moe_local`` at capacities that drop tokens and
dropless, its load-balance loss, and gradients through ``apply_moe``;
then the five properties of tests/test_moe.py held on the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_support import given, settings, st

from repro.configs import get_reduced_config as jax_reduced
from repro.models import moe as jax_moe
from repro.parallel import NO_MESH
from repro_torch.configs import get_reduced_config
from repro_torch.models import moe

TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(E=4, k=2, d=16, f=32, cf=2.0, act="swiglu"):
    """(reference model config, port model config, reference params as
    numpy, the same params as tensors): reduced Mixtral with its MoE set
    to E experts, top-k, capacity factor cf."""
    out = []
    for cfg in (jax_reduced("mixtral-8x7b").model,
                get_reduced_config("mixtral-8x7b").model):
        out.append(dataclasses.replace(
            cfg, d_model=d, ffn_activation=act,
            moe=dataclasses.replace(cfg.moe, num_experts=E, top_k=k,
                                    d_ff_expert=f, capacity_factor=cf)))
    jm, tm = out
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(0), jm,
                                                  jm.moe, jnp.float32))
    return jm, tm, p, {k2: torch.tensor(v) for k2, v in p.items()}


def _x(T, d, seed):
    return np.random.default_rng(seed).standard_normal((T, d)) \
        .astype(np.float32)


def _jax_local(jm, p, x, dropless):
    return jax_moe._moe_local(
        jm, jm.moe, p, jnp.asarray(x), n_local_experts=jm.moe.num_experts,
        expert_offset=jnp.zeros((), jnp.int32), psum_axis=None, es="tp",
        batch_axes=(), dropless=dropless)


def _port_local(tm, p, x, dropless):
    return moe._moe_local(tm, tm.moe, p, torch.from_numpy(x),
                          dropless=dropless)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(),
                               np.asarray(ref, np.float32), **TOL)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 4, 7, 64, 500])
@pytest.mark.parametrize("dropless", [False, True])
def test_capacity_matches_reference(T, dropless):
    for arch in ("mixtral-8x7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        jcfg = jax_reduced(arch).model.moe
        full = get_reduced_config(arch).model.moe
        for m in (full, dataclasses.replace(full, capacity_factor=1.25,
                                            num_experts=7)):
            # every field the reference has; the port-only shared
            # expert's width is unset in these architectures
            assert m.d_ff_shared is None
            jm = dataclasses.replace(jcfg, **{
                f.name: getattr(m, f.name)
                for f in dataclasses.fields(jcfg)})
            assert moe._capacity(m, T, dropless) == \
                jax_moe._capacity(jm, T, dropless)


@pytest.mark.parametrize("A,E,C,seed", [
    (16, 4, 3, 0), (64, 5, 8, 1), (40, 8, 4, 2), (7, 3, 7, 3),
    (128, 16, 12, 4), (24, 2, 4, 5)])
def test_dispatch_indices_bit_exact_on_integer_ids(A, E, C, seed):
    """Integer expert ids drawn from few experts (many ties): order,
    destination rows and the keep mask equal the reference's exactly,
    overflow rows included."""
    ids = np.random.default_rng(seed).integers(0, E, A)
    ref = jax_moe._dispatch_indices(jnp.asarray(ids), E, C)
    out = moe._dispatch_indices(torch.from_numpy(ids), E, C)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dispatch_sort_is_stable():
    """All assignments to one expert: the sort keeps flat order, so the
    first C are kept, in order, and the rest overflow."""
    order, dest, keep = moe._dispatch_indices(
        torch.full((10,), 2, dtype=torch.int64), 4, 6)
    assert order.tolist() == list(range(10))
    assert dest.tolist() == [12, 13, 14, 15, 16, 17] + [24] * 4
    assert keep.tolist() == [True] * 6 + [False] * 4


@pytest.mark.parametrize("E,k,cf,T", [
    (4, 2, 0.25, 64),       # tests/test_moe.py's capacity that drops
    (8, 2, 1.25, 64),       # Mixtral's un-reduced capacity factor
    (16, 8, 0.5, 64),       # Kimi-K2's top-8, half its load dropped
    (4, 2, 2.0, 33)])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_local_matches_jax(E, k, cf, T, dropless):
    jm, tm, jp, tp = _setup(E=E, k=k, cf=cf)
    x = _x(T, jm.d_model, seed=E + T)
    y_ref, aux_ref = _jax_local(jm, jp, x, dropless)
    y, aux = _port_local(tm, tp, x, dropless)
    _close(y, y_ref)
    _close(aux, aux_ref)
    if not dropless and cf < 2.0:
        # the capacity is below the largest expert's load: tokens drop
        top = torch.topk(torch.softmax(torch.from_numpy(x) @ tp["router"],
                                       -1), k, -1).indices
        load = torch.bincount(top.reshape(-1), minlength=E).max()
        assert load > moe._capacity(tm.moe, T, False)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_moe_grads_match_jax(act):
    """Gradients of sum(y^2) + aux through apply_moe, with respect to
    every parameter (the router through the gates and the aux loss) and
    the input, at a capacity that drops tokens; a non-GLU activation has
    no w_gate."""
    jm, tm, jp, tp = _setup(E=4, k=2, cf=0.5, act=act)
    assert ("w_gate" in jp) == (act == "swiglu")
    x = np.random.default_rng(7).standard_normal((2, 24, jm.d_model)) \
        .astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_moe.apply_moe(NO_MESH, jm, jm.moe, p, xx)
        return jnp.sum(y ** 2) + aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k2: v.clone().requires_grad_() for k2, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.apply_moe(tm, tm.moe, leaves, xt)
    (torch.sum(y ** 2) + aux).backward()
    for name in jp:
        _close(leaves[name].grad, jg[name])
    _close(xt.grad, jgx)


def test_router_promotes_against_a_bf16_router():
    """Under compute casting the router is bf16: ``x.float() @ router``
    is an fp32 product in JAX, and so it is here."""
    jm, tm, jp, tp = _setup()
    x = _x(8, jm.d_model, 3)
    p16 = {k2: v.to(torch.bfloat16) for k2, v in tp.items()}
    y, aux = moe._moe_local(tm, tm.moe, p16,
                            torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    ref = jax_moe._moe_local(
        jm, jm.moe, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp),
        jnp.asarray(x, jnp.bfloat16), n_local_experts=4,
        expert_offset=jnp.zeros((), jnp.int32), psum_axis=None, es="tp",
        batch_axes=())
    np.testing.assert_allclose(float(aux), float(ref[1]), rtol=1e-2)


def test_init_moe_matches_the_reference_tree():
    """Same leaves, shapes and dtypes as the reference's init_moe (the
    router fp32 whatever the dtype); expert weights drawn at the
    reference's scale, 1/sqrt(E*d) (truncated at 2)."""
    jm, tm, jp, _ = _setup(E=8, d=64, f=48)
    tp = moe.init_moe(tm, tm.moe, torch.bfloat16, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    assert set(tp) == set(jp)
    for name, v in jp.items():
        assert tuple(tp[name].shape) == v.shape, name
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == torch.bfloat16
    scale = 1.0 / np.sqrt(8 * 64)
    w = tp["w_up"].float()
    assert float(w.abs().max()) <= 2 * scale * 1.01
    assert 0.8 * scale < float(w.std()) < 0.9 * scale
    assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------------------
# the properties of tests/test_moe.py, on the port
# ---------------------------------------------------------------------------

@given(T=st.integers(2, 64), seed=st.integers(0, 100))
@settings(max_examples=20, deadline=None)
def test_dropless_conservation(T, seed):
    """Dropless: every token gets exactly its top-k expert outputs with
    weights summing to 1, so doubling every expert's output doubles y."""
    _, tm, _, tp = _setup()
    x = _x(T, tm.d_model, seed)
    y, _ = _port_local(tm, tp, x, True)
    y2, _ = _port_local(tm, dict(tp, w_down=tp["w_down"] * 2), x, True)
    np.testing.assert_allclose(y2.numpy(), 2 * y.numpy(), rtol=1e-5,
                               atol=1e-5)


@given(T=st.integers(4, 48), seed=st.integers(0, 50))
@settings(max_examples=20, deadline=None)
def test_dispatch_indices_capacity(T, seed):
    E, C = 5, 3
    eidx = np.random.default_rng(seed).integers(0, E, T)
    _, dest, keep = moe._dispatch_indices(torch.from_numpy(eidx), E, C)
    kept = dest.numpy()[keep.numpy()]
    assert len(set(kept.tolist())) == len(kept)
    assert (kept < E * C).all()
    counts = np.bincount(eidx, minlength=E)
    for e in range(E):
        got = ((kept >= e * C) & (kept < (e + 1) * C)).sum()
        assert got == min(counts[e], C)


def test_capacity_drops_overflow():
    """A capacity of a quarter: assignments drop, and a token whose
    every assignment dropped comes out as a zero row; all finite."""
    _, tm, _, tp = _setup(cf=0.25)
    x = _x(64, tm.d_model, 0)
    y, _ = _port_local(tm, tp, x, False)
    assert torch.isfinite(y).all()
    top = torch.topk(torch.softmax(torch.from_numpy(x) @ tp["router"], -1),
                     2, -1).indices.reshape(-1)
    _, _, keep = moe._dispatch_indices(top, 4, moe._capacity(tm.moe, 64,
                                                             False))
    assert not keep.all()


def test_aux_loss_uniform_router_is_bounded():
    """With an all-zero router (uniform gates), E * sum(f_e * P_e) is
    finite, positive and at most E times the weight."""
    _, tm, _, tp = _setup(E=4, k=1)
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    _, aux = _port_local(tm, tp, _x(4096, tm.d_model, 0), True)
    assert 0 < float(aux) < 4 * tm.moe.aux_loss_weight * 4


def test_moe_grads_flow():
    _, tm, _, tp = _setup()
    leaves = {k2: v.clone().requires_grad_() for k2, v in tp.items()}
    y, aux = moe._moe_local(tm, tm.moe, leaves,
                            torch.from_numpy(_x(8, tm.d_model, 0)),
                            dropless=True)
    (torch.sum(y ** 2) + aux).backward()
    for name in ("router", "w_up", "w_down", "w_gate"):
        assert bool((leaves[name].grad != 0).any()), name
