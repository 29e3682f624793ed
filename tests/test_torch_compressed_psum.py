"""``compressed_psum`` (``repro_torch.distributed.compression``): the int8
all-reduce-mean over four gloo ranks against the reference's under
``shard_map`` on four fake JAX devices.

The ranks are spawned once (``torch.multiprocessing``, ``file://``
rendezvous in the test's temporary directory, each join limited); the
reference runs meanwhile in a subprocess under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and hands its
results back through an ``.npz``.  Inputs are seeded numpy arrays, one a
rank, whose size is no multiple of 4 x 256 (the padding path) and whose
blocks have scales three orders of magnitude apart.

Tolerances: the two packages within one int8 step of the second
quantization (a block of the mean's largest |value| / 127: XLA compiles
``x / 127`` into ``x * (1 / 127)``, which can move a scale by an ulp and
tip a rounding; measured, they differ by at most 2.4e-7, an ulp of the
dequantized values, and never by a step); each within 2.5 steps of the
true mean (the reference's own test, ``tests/test_sharding_distributed.py``),
and every element within half a step of each quantization of it.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

WORLD, BLOCK = 4, 256
SHAPES = {"ragged": (37, 53), "aligned": (4 * BLOCK, 3)}
JOIN_TIMEOUT_S = 240
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, shape in SHAPES.items():
        x = rng.standard_normal((WORLD, *shape)).astype(np.float32)
        x.reshape(WORLD, -1)[:, : BLOCK] *= 1e-3  # a block far smaller than the rest
        out[name] = x
    return out


def _rank_main(rank, tmp):
    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{tmp}/rendezvous", WORLD, rank, backend="gloo")
    try:
        mesh = tmesh.make_production_mesh(device="cpu")
        got = {name: tcomp.compressed_psum(torch.from_numpy(x[rank]), mesh).numpy()
               for name, x in _inputs().items()}
        np.savez(f"{tmp}/rank{rank}.npz", **got)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed.compression import compressed_psum
    mesh = jax.make_mesh((4,), ("data",))
    f = jax.jit(shard_map(lambda s: compressed_psum(s[0], "data")[None], mesh=mesh,
                          in_specs=P("data"), out_specs=P("data"), check_rep=False))
    with np.load(sys.argv[1]) as data:
        out = {k: np.asarray(f(jnp.asarray(data[k]))) for k in data.files}
    np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("psum"))
    np.savez(f"{tmp}/inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), f"{tmp}/inputs.npz",
                            f"{tmp}/reference.npz"], env=env, stderr=subprocess.PIPE, text=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, tmp)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        _, err = ref.communicate(timeout=JOIN_TIMEOUT_S)
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    assert ref.returncode == 0, err[-3000:]
    assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    got = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(WORLD)]
    return got, dict(np.load(f"{tmp}/reference.npz"))


def _block_steps(x: np.ndarray) -> np.ndarray:
    """Each element's int8 step in its block of ``x`` flattened and padded
    to BLOCK values: the block's largest |value| / 127."""
    flat = x.reshape(-1)
    blocks = np.pad(flat, (0, (-flat.size) % BLOCK)).reshape(-1, BLOCK)
    return np.repeat(np.abs(blocks).max(1) / 127, BLOCK)[: flat.size].reshape(x.shape)


@pytest.mark.parametrize("name", list(SHAPES))
def test_compressed_psum_matches_reference_and_the_mean(results, name):
    got, ref = results
    x = _inputs()[name]
    mean = x.mean(0)
    first = np.max([_block_steps(x[r]) for r in range(WORLD)], axis=0)  # per chunk, padded alike
    second = _block_steps(mean)
    scale = np.abs(x).max() / 127
    for r in range(WORLD):
        g = got[r][name]
        assert g.shape == mean.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, got[0][name])  # every rank the same bits
        off = np.abs(g - ref[name][r])
        assert (off <= second).all(), off.max()
        assert np.abs(g - mean).max() <= 2.5 * scale + 1e-6
        # element by element: half a step of each quantization, f32 slack
        assert (np.abs(g - mean) <= (first + second) / 2 + 1e-6).all()


def test_compressed_psum_of_one_member_is_its_input():
    x = torch.from_numpy(_inputs()["ragged"][0])
    assert tcomp.compressed_psum(x, tmesh.make_local_mesh("cpu")) is x
