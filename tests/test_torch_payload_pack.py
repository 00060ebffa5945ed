"""The port's payload pack / unpack (K1, K2) and serialization on CPU
tensors, where the wrappers run their plain versions, against the JAX
package (its Pallas kernels in interpret mode), byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_support import given, settings, st

import repro.core.serialization as ref_ser
from repro.kernels.payload_pack import pack as ref_pack
from repro.kernels.payload_pack import pack_ref
from repro.kernels.payload_pack import unpack as ref_unpack
import repro_torch.core.serialization as port_ser
from repro_torch.kernels import payload_pack as pp
from repro_torch.kernels.payload_pack import ops as pp_ops


def _bufs(sizes, seed, rows=None):
    rng = np.random.default_rng(seed)
    shape = (lambda s: (s,)) if rows is None else (lambda s: (rows, s))
    return [rng.integers(0, 255, shape(s), dtype=np.uint8) for s in sizes]


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


# the sizes of tests/test_kernels.py's round-trip property
@given(sizes=st.lists(st.integers(1, 4096), min_size=1, max_size=8),
       seed=st.integers(0, 999))
@settings(max_examples=25, deadline=None)
def test_pack_unpack_equal_reference_bytes(sizes, seed):
    host = _bufs(sizes, seed)
    want, want_sizes = ref_pack([jnp.asarray(b) for b in host],
                                interpret=True)
    got, got_sizes = pp.pack(_t(host))
    assert got_sizes == want_sizes == tuple(sizes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    outs = pp.unpack(got, got_sizes)
    ref_outs = ref_unpack(want, want_sizes, interpret=True)
    for a, b, h in zip(outs, ref_outs, host):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), h)


def test_pack_matches_reference_when_aligned():
    host = _bufs((128, 512, 1024, 128), 0)
    got, _ = pp.pack(_t(host))
    want = pack_ref([jnp.asarray(b) for b in host])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", [1, 3, 8])
@pytest.mark.parametrize("pad", [True, False])
def test_rows_pack_each_row_as_the_reference_packs_it(rows, pad):
    sizes = (10, 300, 128, 4097, 1)
    host = _bufs(sizes, rows, rows=rows)
    got, got_sizes = pp.pack(_t(host), pad=pad)
    assert got_sizes == sizes
    width = sum(s + (-s) % 128 for s in sizes) if pad else sum(sizes)
    assert tuple(got.shape) == (rows, width)
    for r in range(rows):
        row = [b[r] for b in host]
        if pad:
            want, _ = ref_pack([jnp.asarray(b) for b in row],
                               interpret=True)
        else:
            want = np.concatenate(row)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
    for a, h in zip(pp.unpack(got, sizes, pad=pad), host):
        np.testing.assert_array_equal(a.numpy(), h)


def test_pad_bytes_are_zero():
    host = [np.full((4, s), 255, np.uint8) for s in (1, 127, 129, 200)]
    got, _ = pp.pack(_t(host))
    off = 0
    for s in (1, 127, 129, 200):
        p = s + (-s) % 128
        assert (got[:, off:off + s] == 255).all()
        assert (got[:, off + s:off + p] == 0).all()
        off += p


def test_cpu_tensors_launch_nothing():
    before = (pp_ops.pack.launches, pp_ops.unpack.launches)
    packed, sizes = pp.pack(_t(_bufs((10, 20), 0)))
    pp.unpack(packed, sizes)
    assert (pp_ops.pack.launches, pp_ops.unpack.launches) == before


def test_wrappers_refuse_what_they_cannot_pack():
    with pytest.raises(ValueError, match="no buffers"):
        pp.pack([])
    with pytest.raises(ValueError, match="leading shapes"):
        pp.pack([torch.zeros(2, 8, dtype=torch.uint8),
                  torch.zeros(3, 8, dtype=torch.uint8)])
    with pytest.raises(ValueError, match="need"):
        pp.unpack(torch.zeros(100, dtype=torch.uint8), [128])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pp.pack([torch.zeros(8, dtype=torch.uint8, device="meta")])


def test_to_card_names_the_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        pp.to_card([np.zeros(4, np.uint8)])


# ---------------------------------------------------------------------------
# serialization: (N, size) uint8 rows, packed along the last axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(128, 10240, 1048576, 128),
                                   (10, 1, 300, 4097, 77)],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("rows", [1, 4])
def test_serialization_equals_reference(sizes, rows):
    host = _bufs(sizes, 1, rows=rows)
    want, want_meta = ref_ser.pack([jnp.asarray(b) for b in host])
    got, got_meta = port_ser.pack(_t(host))
    assert got_meta == want_meta
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(port_ser.unpack(got, got_meta),
                    ref_ser.unpack(want, want_meta)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
