"""Temperature sampling: the port's ``core/prng.py`` against
``jax.random`` (keys, bits, uniform and Gumbel noise, categorical draws)
and the port's serve engine against the JAX engine at a temperature, on
the same converted parameters, directly and through a scheduler that
preempts."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.parallel import NO_MESH
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.scheduler import ServeScheduler as JaxServeScheduler
from repro_torch.configs import get_reduced_config
from repro_torch.core import prng
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.scheduler import ServeScheduler

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 5, 2**31 - 1, -1, 2**32 + 5)
SHAPES = ((4, 4099), (3, 151936))
DTYPES = ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32))
GUMBEL_F32_TOL = 2e-6
TEMPERATURE, SEED = 0.9, 5
ENGINE_ARCHS = ("qwen3-8b", "rwkv6-1.6b", "mixtral-8x7b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one thread each, so that parallel test workers do
    not oversubscribe the cores (the fault tier's timing tests share
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey(key):
    return jnp.asarray(np.array(key, dtype=np.uint32))


def _pair(jkey):
    return tuple(int(w) for w in np.asarray(jkey))


def _key(seed):
    return prng.split(prng.prng_key(seed))[1]


def test_jax_threefry_is_partitionable():
    """The key layout the port implements: fold-like split and bits
    over the 64-bit iota."""
    assert jax.config.jax_threefry_partitionable


def test_prng_key_takes_the_low_word():
    assert prng.prng_key(-1) == (0, 4294967295)
    assert prng.prng_key(2**32 + 5) == (0, 5)
    assert prng.split(prng.prng_key(0)) == ((1797259609, 2579123966),
                                            (928981903, 3453687069))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_chain_equals_jax(seed):
    """PRNGKey and then ten splits, each side's keys bit for bit."""
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert _pair(jk) == tk
    for _ in range(10):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        assert (_pair(jk), _pair(jsub)) == (tk, tsub)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("width", (8, 16, 32))
def test_random_bits_equal_jax(shape, width):
    key = _key(7)
    want = np.asarray(jax.random.bits(_jkey(key), shape,
                                      jnp.dtype(f"uint{width}")))
    got = prng.random_bits(key, width, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,jdtype", DTYPES)
def test_uniform_and_gumbel_equal_jax(shape, dtype, jdtype):
    """Uniform bit for bit in both dtypes; Gumbel bit for bit in
    bfloat16 and within GUMBEL_F32_TOL in float32 (the two libraries'
    fp32 ``log`` round differently in the last place)."""
    key = _key(11)
    ju = np.asarray(jax.random.uniform(_jkey(key), shape, jdtype)
                    .astype(jnp.float32))
    tu = prng.uniform(key, shape, dtype)
    assert tu.dtype == dtype
    np.testing.assert_array_equal(tu.float().numpy(), ju)
    jg = np.asarray(jax.random.gumbel(_jkey(key), shape, jdtype)
                    .astype(jnp.float32))
    tg = prng.gumbel(key, shape, dtype)
    assert tg.dtype == dtype and np.isfinite(tg.float().numpy()).all()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(tg.float().numpy(), jg)
    else:
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                                   atol=GUMBEL_F32_TOL)


def test_other_dtypes_raise():
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError):
            prng.gumbel(_key(0), (2, 3), dtype)
    with pytest.raises(ValueError):
        prng.random_bits(_key(0), 64, (2,))


def test_bf16_ulps_counts_bf16_spacings():
    """The measure the card's bf16 noise is held to: 0 for equal values,
    1 for neighbours, at any binade and sign."""
    a = torch.tensor([1.0, -3.0, 1e-30, 100.0], dtype=torch.bfloat16)
    up = (a.view(torch.int16) + 1).view(torch.bfloat16)
    assert prng.bf16_ulps(a, a).tolist() == [0.0] * 4
    assert prng.bf16_ulps(a, up).tolist() == [1.0] * 4
    assert prng.bf16_ulps(up, a).tolist() == [1.0] * 4


@pytest.mark.parametrize("temperature", (0.7, 1.3))
def test_categorical_equals_jax(temperature):
    """64 keys of one chain over random (4, 151936) fp32 logits (Qwen3's
    vocabulary): the same tokens as ``jax.random.categorical``."""
    logits = (np.random.default_rng(3).standard_normal((4, 151936))
              .astype(np.float32) * 3)
    jl = jnp.asarray(logits) / temperature
    tl = torch.from_numpy(logits) / torch.tensor(temperature)
    key = prng.prng_key(21)
    for _ in range(64):
        key, sub = prng.split(key)
        want = np.asarray(jax.random.categorical(_jkey(sub), jl))
        np.testing.assert_array_equal(prng.categorical(sub, tl).numpy(),
                                      want)


def _prompts(rows, plen, seed):
    return np.random.default_rng(seed).integers(0, 128, (rows, plen),
                                                dtype=np.int32)


def _engines(arch):
    jcfg = jax_reduced(arch)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    scfg = dict(max_seq=40, max_new_tokens=5, temperature=TEMPERATURE,
                seed=SEED)
    jeng = JaxServeEngine(NO_MESH, jcfg, params, JaxServeConfig(**scfg))
    teng = ServeEngine(get_reduced_config(arch),
                       from_jax_params(jax.tree.map(np.asarray, params)),
                       ServeConfig(**scfg))
    return jeng, teng


def _preempted(sched, prompts, new):
    """Both requests' tokens through ``sched``, whose KV budget preempts
    at least one of them."""
    reqs = [sched.submit(p, new) for p in prompts]
    while not all(r.finished for r in reqs):
        sched.step()
    assert sched.counters["preempted"] >= 1
    return [np.stack(r.tokens, axis=1) for r in reqs]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_samples_the_references_tokens(arch):
    """At temperature 0.9, seed 5, on the same reduced fp32 parameters:
    the port's tokens equal the JAX engine's, for one request directly
    and for two requests through a scheduler whose KV budget preempts
    (rebuild replays the key chain on both sides)."""
    jeng, teng = _engines(arch)
    prompts = _prompts(2, 8, 0)
    want = jeng.generate(prompts)
    greedy = JaxServeEngine(NO_MESH, jeng.acfg, jeng.params,
                            JaxServeConfig(max_seq=40, max_new_tokens=5))
    assert not np.array_equal(want, greedy.generate(prompts))
    np.testing.assert_array_equal(teng.generate(prompts), want)
    pair = [_prompts(1, 8, 1), _prompts(1, 8, 2)]
    kw = dict(max_batch=4, kv_blocks=21, block_size=1)
    want = _preempted(JaxServeScheduler(jeng, **kw), pair, 4)
    got = _preempted(ServeScheduler(teng, **kw), pair, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_chip_smoke_key_chain_is_jaxs():
    """``chip_smoke.py``'s SAMPLE_CHAIN (the draw keys of the chain from
    seed 0, 8 splits deep, checked on the card) is JAX's."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    chain = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", "") == "SAMPLE_CHAIN")
    key, want = jax.random.PRNGKey(0), []
    for _ in range(8):
        key, sub = jax.random.split(key)
        want.append(_pair(sub))
    assert [tuple(k) for k in chain] == want
