"""The port's flash attention against the JAX package's Pallas kernel
(interpret mode on the CPU, as tests/test_kernels.py runs it): the same
numpy inputs through both, at the reference's tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 flash_attention)

# the cases of tests/test_kernels.py
FA_CASES = [
    # B, Sq, H, KV, dh, causal, window, softcap
    (2, 128, 4, 2, 64, True, None, None),
    (1, 256, 4, 4, 64, True, 64, None),
    (2, 128, 8, 2, 32, True, None, 50.0),
    (1, 192, 4, 1, 128, True, None, None),     # MQA, non-pow2 seq
    (2, 64, 4, 2, 64, False, None, None),      # bidirectional (encoder)
    (1, 320, 6, 2, 64, True, 128, 30.0),       # window + softcap
]
# fp32: the kernel's own test tolerance; bf16: one bf16 rounding of
# outputs of magnitude ~1 plus the rounded probabilities
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, S, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, dh), (B, S, KV, dh), (B, S, KV, dh))]


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_kernel(case, dtype):
    B, S, H, KV, dh, causal, window, cap = case
    arrays = _qkv(B, S, H, KV, dh, seed=S + H)
    ref = jax_flash(*[jnp.asarray(a, dtype) for a in arrays],
                    causal, window, cap)
    out = flash_attention(*[torch.from_numpy(a).to(getattr(torch, dtype))
                            for a in arrays], causal, window, cap)
    assert out.dtype == getattr(torch, dtype) and out.shape == (B, S, H, dh)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOLS[dtype], rtol=TOLS[dtype])


def test_grad_matches_jax():
    """Backward recomputes through attention_plain, as the reference's
    custom VJP recomputes through attention_ref (the case of
    tests/test_kernels.py::test_flash_attention_grad_matches_ref)."""
    B, S, H, KV, dh = 1, 64, 4, 2, 32
    arrays = _qkv(B, S, H, KV, dh, seed=7)

    def f_jax(q, k, v):
        return jnp.sum(jax_flash(q, k, v, True, None, None) ** 2)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (flash_attention(*leaves, True, None, None) ** 2).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_plain_matches_jax_ref_with_scale():
    """attention_plain is the counterpart of attention_ref, explicit
    scale included."""
    arrays = _qkv(2, 40, 6, 3, 32, seed=3)
    ref = jax.jit(attention_ref, static_argnames=(
        "causal", "window", "softcap", "scale"))(
        *map(jnp.asarray, arrays), causal=True, window=9, softcap=20.0,
        scale=0.3)
    out = attention_plain(*map(torch.from_numpy, arrays), causal=True,
                          window=9, softcap=20.0, scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = map(torch.from_numpy, _qkv(1, 24, 4, 2, 16, seed=1))
    flash_attention.launches = 0
    out = flash_attention(q, k, v, True, 8, None)
    assert flash_attention.launches == 0
    assert torch.equal(out, attention_plain(q, k, v, True, 8, None))


def test_non_cpu_tensors_never_fall_back():
    """A tensor that is not on the CPU goes to the kernel's launcher,
    which refuses anything but CUDA: there is no silent plain path."""
    q, k, v = (t.to("meta") for t in
               map(torch.from_numpy, _qkv(1, 8, 2, 1, 16, seed=2)))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v)


# which kernel runs (dtype, dh): a function of those two alone
PATH_TABLE = [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 32, "mma"),
    (torch.bfloat16, 256, "mma"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
]


@pytest.mark.parametrize("dtype,dh,path", PATH_TABLE)
def test_kernel_path_is_pinned_by_dtype_and_head_dim(dtype, dh, path):
    from repro_torch.kernels.flash_attention import kernel_path
    from repro_torch.kernels.flash_attention import ops
    assert kernel_path(dtype, dh) == path
    assert path in ops.PATHS and set(flash_attention.launches_by_path) \
        == set(ops.PATHS)


def test_cpu_calls_count_no_path():
    q, k, v = map(torch.from_numpy, _qkv(1, 16, 2, 1, 64, seed=4))
    before = dict(flash_attention.launches_by_path)
    flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), True)
    assert flash_attention.launches_by_path == before
