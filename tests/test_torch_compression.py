"""The port's gradient compression and fault tolerance
(``repro_torch.distributed.compression`` / ``fault_tolerance``) against
the reference's, on the CPU.

Held bit for bit on seeded inputs: ``quantize_int8`` codes, scales and
n, ``dequantize_int8``, and 50 rounds of ``ef_compress_decompress``
(outputs and residuals), at n not a multiple of 1,024, an all-zero block
(scale 0 and the 1e-12 floor), exact .5 ties (half to even) and a bf16
input.  ``compressed_psum`` on 4 gloo ranks (``spawn_local``) against
the reference's ``psum`` inside ``shard_map`` on 4 emulated XLA devices
(one subprocess): the int32 code sums exactly; the scale sums and the
output within 2 ulps, because the two packages add the 4 float32 scales
in their own orders: XLA's psum on the CPU devices in rank order,
((s0 + s1) + s2) + s3, gloo's ring all-reduce in an order of its own
(neither that nor (s0 + s1) + (s2 + s3)); measured 1 ulp apart at most.  ``StepWatchdog`` under a scripted clock and ``exclude_and_remesh``
over a grid against the reference.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as jc  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro_torch.distributed import compression as tc  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.launch import spawn_local  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N_PSUM, RANKS, TIMEOUT_S = 5_000, 4, 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(case: str) -> np.ndarray:
    """float32 inputs of each edge: ``ragged`` n = 3,000 (not a multiple of
    1,024); ``zero_block`` a block of zeros between two random ones;
    ``ties`` values on exact .5 codes (scale 1 a block: each block's
    largest magnitude is 127); ``wide`` 3 x 5 x 701 scaled by 1e3."""
    rng = np.random.default_rng(7)
    if case == "ragged":
        return rng.normal(size=3000).astype(np.float32)
    if case == "zero_block":
        x = rng.normal(size=3 * 1024).astype(np.float32)
        x[1024:2048] = 0.0
        return x
    if case == "ties":
        x = (rng.integers(-126, 126, size=2048) + 0.5).astype(np.float32)
        x[::1024] = 127.0
        return x
    return (rng.normal(size=(3, 5, 701)) * 1e3).astype(np.float32)


CASES = ["ragged", "zero_block", "ties", "wide"]


def assert_quant_equal(x_t: torch.Tensor, x_j) -> None:
    q, s, n = tc.quantize_int8(x_t)
    jq, js, jn = jc.quantize_int8(x_j)
    assert n == jn and q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tc.dequantize_int8(q, s, n, tuple(x_t.shape))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jc.dequantize_int8(jq, js, jn, x_j.shape)))


@pytest.mark.parametrize("case", CASES)
def test_quantize_int8_equals_reference(case):
    x = inputs(case)
    assert_quant_equal(torch.from_numpy(x), jnp.asarray(x))
    if case == "zero_block":
        assert float(tc.quantize_int8(torch.from_numpy(x))[1][1]) == 0.0
    if case == "ties":  # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
        q = tc.quantize_int8(torch.from_numpy(x))[0].reshape(-1)
        np.testing.assert_array_equal(q[1:].numpy(), np.round(x[1:]).astype(np.int8))


def test_quantize_int8_bf16_input():
    x = np.random.default_rng(3).normal(size=2500).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert_quant_equal(xt, jnp.asarray(xt.float().numpy(), jnp.bfloat16))


def test_ef_compress_decompress_equals_reference_over_50_rounds():
    rng = np.random.default_rng(1)
    shapes = {"w": (256,), "b": (3, 700)}
    draw = lambda: {k: (rng.normal(size=s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
    g0 = draw()
    tstate = tc.ef_init({k: torch.from_numpy(v) for k, v in g0.items()})
    jstate = jc.ef_init({k: jnp.asarray(v) for k, v in g0.items()})
    for _ in range(50):
        g = draw()
        sent, tstate = tc.ef_compress_decompress({k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        jsent, jstate = jc.ef_compress_decompress({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        for k in shapes:
            np.testing.assert_array_equal(sent[k].numpy(), np.asarray(jsent[k]), err_msg=k)
            np.testing.assert_array_equal(tstate.residual[k].numpy(),
                                          np.asarray(jstate.residual[k]), err_msg=k)


def test_int8_quant_error_bounded():
    """The reference's ``test_substrate.py`` contract, on the port."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1000,)).astype(np.float32) * 3.0)
    q, s, n = tc.quantize_int8(x)
    err = (tc.dequantize_int8(q, s, n, x.shape) - x).abs()
    # at most one quantisation step, scale = max |block| / 127
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_error_feedback_preserves_signal():
    """The reference's ``test_substrate.py`` contract, on the port: the
    sum of the sent gradients plus the residual is the sum of the true
    ones, and the residual stays bounded."""
    rng = np.random.default_rng(1)
    grads = {"w": torch.from_numpy((rng.normal(size=(256,)) * 1e-3).astype(np.float32))}
    state = tc.ef_init(grads)
    total_true, total_sent = np.zeros(256), np.zeros(256)
    for _ in range(50):
        g = {"w": torch.from_numpy((rng.normal(size=(256,)) * 1e-3).astype(np.float32))}
        sent, state = tc.ef_compress_decompress(g, state)
        total_true += g["w"].numpy()
        total_sent += sent["w"].numpy()
    resid = state.residual["w"].numpy()
    np.testing.assert_allclose(total_sent + resid, total_true, rtol=1e-4, atol=1e-6)
    assert np.abs(resid).max() < 1e-3


def psum_input(rank: int) -> np.ndarray:
    x = np.random.default_rng(100 + rank).normal(size=N_PSUM).astype(np.float32)
    x[:1024] *= 1e-3 * (rank + 1)  # a first block of another scale on every rank
    return x


def _psum_rank(mesh):
    torch.set_num_threads(1)  # a spawned rank starts with every core's thread
    group = mesh.group("model")
    x = torch.from_numpy(psum_input(mesh.rank))
    q_sum, s_sum, k, n = tc.int8_sums(x, group)
    out = tc.compressed_psum(x, group)
    return {"q_sum": q_sum.numpy(), "s_sum": s_sum.numpy(), "k": k, "n": n, "out": out.numpy()}


REFERENCE_PSUM = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.distributed.compression import compressed_psum, quantize_int8

    xs = np.load(sys.argv[1])["xs"]
    mesh = jax.make_mesh((xs.shape[0],), ("model",))

    def parts(x):
        q, s, n = quantize_int8(x[0])
        return (jax.lax.psum(q.astype(jnp.int32), "model")[None],
                jax.lax.psum(s, "model")[None], compressed_psum(x[0], "model")[None])

    f = shard_map(parts, mesh=mesh, in_specs=P("model"),
                  out_specs=(P("model"), P("model"), P("model")), check_rep=False)
    q_sum, s_sum, out = map(np.asarray, jax.jit(f)(jnp.asarray(xs)))
    np.savez(sys.argv[2], q_sum=q_sum, s_sum=s_sum, out=out)
""")


def test_compressed_psum_matches_reference_shard_map(tmp_path):
    xs = np.stack([psum_input(r) for r in range(RANKS)])
    np.savez(tmp_path / "in.npz", xs=xs)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_PSUM, str(tmp_path / "in.npz"),
                            str(tmp_path / "out.npz")], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_local(_psum_rank, (1, RANKS), backend="gloo", device="cpu",
                            timeout_s=TIMEOUT_S)
    finally:
        _, err = ref.communicate(timeout=TIMEOUT_S)
    assert ref.returncode == 0, err
    want = np.load(tmp_path / "out.npz")
    for r, got in enumerate(ranks):
        assert got["k"] == RANKS and got["n"] == N_PSUM
        np.testing.assert_array_equal(got["q_sum"], want["q_sum"][r])  # exact
        # 4 scales added in two orders: the sums and the outputs within ulps
        np.testing.assert_array_max_ulp(got["s_sum"], want["s_sum"][r], maxulp=2)
        np.testing.assert_array_max_ulp(got["out"], want["out"][r], maxulp=2)
        # every rank holds the same sum
        np.testing.assert_array_equal(got["out"], ranks[0]["out"])


def test_step_watchdog_equals_reference(monkeypatch):
    """A scripted clock: both watchdogs trip on the same steps, keep the
    same history (its length capped), and give the same p50 and
    adaptive limit; the callback gets each tripping step's seconds."""
    durations = [0.5, 2.5, 1.0, 0.2, 3.0, 1.5, 0.7, 9.0] * 3
    got = {}
    for name, mod in (("port", tft), ("reference", jft)):
        # enter reads t0, exit reads t1: each pair spans one duration
        starts = np.concatenate([[0.0], np.cumsum(durations)])
        seq = iter([t for i in range(len(durations)) for t in (starts[i], starts[i + 1])])
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(seq)))
        tripped = []
        wd = mod.StepWatchdog(limit_s=2.0, on_trip=tripped.append, history_len=16)
        for _ in durations:
            with wd:
                pass
        got[name] = (wd.trips, wd.p50, wd.adaptive_limit(), wd.adaptive_limit(1.5),
                     len(wd._hist), tripped)
    assert got["port"] == got["reference"]
    assert got["port"][0] == 9 and got["port"][4] == 16


def test_exclude_and_remesh_equals_reference():
    for n_hosts in (1, 2, 4, 7, 8, 16, 33, 64):
        hosts = [f"h{i}" for i in range(n_hosts)]
        rng = np.random.default_rng(n_hosts)
        bad_sets = [set(), {hosts[0]}, set(rng.choice(hosts, size=min(3, n_hosts), replace=False)),
                    set(hosts)]
        for bad in bad_sets:
            for per_host in (1, 4, 8, 16):
                got = tft.exclude_and_remesh(hosts, bad, per_host_devices=per_host)
                assert got == jft.exclude_and_remesh(hosts, bad, per_host_devices=per_host)
                kept, data = got
                assert data == 1 or data * 16 <= len(kept) * per_host
    # model stays 16: under 32 devices the data axis is 1
    assert tft.exclude_and_remesh(list(range(7)), set(), per_host_devices=4) == (list(range(7)), 1)
    assert json.dumps(tft.exclude_and_remesh(list(range(8)), set())[1]) == "2"
