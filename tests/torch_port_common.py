"""Shared set-up of the tests/test_torch_port_*.py files: small dims that
still pass the JAX kernel gates, and one random flax-layout weight tree
loaded into both packages.

Both packages get the same inputs, made with numpy from a seed; the port
runs on the CPU, where every kernel wrapper takes its plain version."""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmhrl_tpu.ops import attention as jfused
from bmhrl_tpu_torch.models.blocks import Draws

# d_k = 256 / 2 = 128 passes the flash gate; draw = 128 passes the folded
# gate; Sv = 128 and Sa = 160 (not a multiple of 128) reach the flash kernel
DIMS = dict(voc_size=40, d_video=128, d_audio=128, d_model=256,
            d_model_caps=32, att_heads=2, att_layers=2, d_goal=16,
            d_ff_v=64, d_ff_a=64, d_ff_c=64)
B, SV, SA, MAX_LEN = 3, 128, 160, 8
PAD, BOS, EOS = 1, 2, 3


@contextlib.contextmanager
def jax_kernels(flash=True, folded=True):
    """Set the JAX package's global kernel toggles, restored afterwards (the
    toggles are process-wide and xdist shares a worker between files). The
    toggles are read while tracing, so jit caches are cleared whenever they
    change: a cached trace would keep the toggles it was traced with."""
    before = (jfused.flash_enabled(), jfused._FOLDED_KERNEL)

    def set_toggles(state):
        if state != (jfused.flash_enabled(), jfused._FOLDED_KERNEL):
            jfused.enable_flash(state[0])
            jfused.enable_folded_kernel(state[1])
            jax.clear_caches()

    set_toggles((flash, folded))
    try:
        yield
    finally:
        set_toggles(before)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's port ops on one CPU thread, restored afterwards. The
    tests' tensors are small, and the test workers share the cores: a
    parallel op whose threads wait on each other across busy cores runs
    up to 100x slower than on one thread. A test module takes it with
    ``from torch_port_common import one_torch_thread``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def torch_agent(tree, dims=DIMS):
    from bmhrl_tpu_torch.models.bmhrl import BMHrlAgent
    from bmhrl_tpu_torch.weights import load_jax_params

    model = BMHrlAgent(**dims, dtype=torch.float32, device="cpu")
    return load_jax_params(model, tree).requires_grad_(False)


def jax_agent(dims=DIMS):
    from bmhrl_tpu.models.bmhrl import BMHrlAgent

    return BMHrlAgent(**dims, dtype=jnp.float32)


def features(seed=0, b=B, sv=SV, sa=SA, dv=128, da=128):
    """Numpy rgb/flow/audio with ragged padding (zero rows at the end)."""
    rng = np.random.RandomState(seed)
    f = {"rgb": rng.rand(b, sv, dv).astype(np.float32),
         "flow": rng.rand(b, sv, dv).astype(np.float32),
         "audio": rng.rand(b, sa, da).astype(np.float32)}
    f["rgb"][0, sv - 30:] = 0.0
    f["flow"][0, sv - 30:] = 0.0
    f["audio"][b - 1, sa - 45:] = 0.0
    return f


def to_torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


class RecordingDraws(Draws):
    """CPU ``Draws`` that keeps a copy of every draw, by stream, in order
    (``drawn["sample"]``: the sampled steps' uniforms; ``drawn["noise"]``:
    the exploration normals)."""

    def __init__(self, seed=0):
        super().__init__(seed, "cpu")
        self.drawn = {s: [] for s in self.STREAMS}

    def _draw(self, fn, stream, *args):
        x = super()._draw(fn, stream, *args)
        self.drawn[stream].append(x.numpy().copy())
        return x


@contextlib.contextmanager
def fed_jax_draws(uniforms=(), normals=()):
    """Inside: ``jax.random.categorical`` samples as the port's
    ``Draws.categorical`` does from the next of ``uniforms``, and
    ``jax.random.normal`` returns the next of ``normals``. The JAX decode
    loops draw inside a jitted ``lax.while_loop`` whose body is traced
    once, so each array is popped by an ordered ``io_callback`` at run
    time, one per iteration. The jit caches are cleared on entry and exit
    (a cached trace would keep the real draws); all arrays must be used."""
    from jax.experimental import io_callback

    queues = {"u": [np.asarray(u, np.float32) for u in uniforms],
              "n": [np.asarray(n, np.float32) for n in normals]}

    def fed(name, shape):
        return io_callback(lambda: queues[name].pop(0),
                           jax.ShapeDtypeStruct(tuple(shape), jnp.float32),
                           ordered=True)

    def categorical(key, logits, axis=-1, shape=None, replace=True):
        u = jnp.maximum(fed("u", logits.shape), jnp.finfo(jnp.float32).tiny)
        return jnp.argmax(logits - jnp.log(-jnp.log(u)), axis=axis)

    def normal(key, shape=(), dtype=jnp.float32):
        return fed("n", shape).astype(dtype)

    jax.clear_caches()
    try:
        with mock.patch.object(jax.random, "categorical", categorical), \
                mock.patch.object(jax.random, "normal", normal):
            yield
    finally:
        jax.clear_caches()
    assert not queues["u"] and not queues["n"], {
        k: len(v) for k, v in queues.items()}
