"""The port's fp8-block gradient compression against the reference's.

* `quantize_fp8_block`: codes (as their uint8 bits) and scales bit-equal
  to the reference's, with a padded tail block; the reference's three
  quantizer properties (the round trip within an fp8 step of each
  block's amax, all-zero blocks, the tail's padding);
* `compressed_psum` in four gloo ranks (`_torch_mesh_ref.spawn_port`,
  a ``("pod",)`` mesh) against the reference's under ``shard_map`` over
  four host devices (a subprocess, `_torch_mesh_train_ref`): the sum and
  each rank's new error within 1e-6 (relative to the largest value);
* `apply_to_grads` on a tree of two leaves: every leaf equal to its own
  `compressed_psum`, and the error feedback carried into a second round.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compression as RC
from repro_torch.parallel import compression as TC

from _torch_mesh_ref import spawn_port
from _torch_mesh_train_ref import start_reference
from _torch_threads import one_torch_thread  # noqa: F401

BLOCK = 64
SHAPE = (5, 61)  # 305 values: 5 blocks, the last one padded


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, *SHAPE)).astype(np.float32)
    x[1, 0, :] *= 1e3       # one block far larger than the rest
    x[2, 1, :] = 0.0        # and one that is (nearly) zero
    err = (1e-3 * rng.standard_normal((4, *SHAPE))).astype(np.float32)
    return x, err


def _port_psum(x: np.ndarray, err: np.ndarray, block: int) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel import sharding as shd
    r = dist.get_rank()
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    xs = torch.from_numpy(x[r])
    es = torch.from_numpy(err[r])
    with shd.use_mesh(mesh):
        tot, new = TC.compressed_psum(xs, "pod", es, block)
        tree = {"a": xs, "b": [2 * xs[:3]]}
        e0 = TC.init_error_state(tree)
        s1, e1 = TC.apply_to_grads(tree, e0, "pod", block)
        s2, e2 = TC.apply_to_grads(tree, e1, "pod", block)
        one_a = TC.compressed_psum(tree["a"], "pod", e1["a"], block)
    news = [torch.empty_like(new) for _ in range(4)]
    dist.all_gather(news, new)
    return {"sum": tot.numpy(), "new_err": torch.stack(news).numpy(),
            "tree1": (s1["a"].numpy(), s1["b"][0].numpy()),
            "err1": (e1["a"].numpy(), e1["b"][0].numpy()),
            "tree2_a": s2["a"].numpy(), "one_a": one_a[0].numpy(),
            "err2_a": e2["a"].numpy(), "one_err_a": one_a[1].numpy()}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    x, err = _inputs()
    with start_reference([dict(kind="compress", x=x.tolist(),
                               err=err.tolist(), block=BLOCK)],
                         tmp_path_factory.mktemp("ref")) as ref:
        port = spawn_port(_port_psum, (x, err, BLOCK),
                          tmp_path_factory.mktemp("port"))
        return x, err, port, ref.result()[0]


@pytest.mark.parametrize("row", range(4))
def test_codes_and_scales_bit_equal_the_reference(both, row):
    x, _, _, ref = both
    q, s, pad = TC.quantize_fp8_block(torch.from_numpy(x[row]), BLOCK)
    assert q.dtype == torch.float8_e4m3fn and q.shape == (5, BLOCK)
    assert pad == ref["pads"][row] == 5 * BLOCK - 305
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  ref["codes"][row])
    np.testing.assert_array_equal(s.numpy(), ref["scales"][row])


def test_round_trip_within_an_fp8_step_of_the_amax():
    """The reference's property: each value back within 2^-3 of its
    block's amax / 448 x 448 (e4m3's coarsest relative step)."""
    rng = np.random.default_rng(3)
    for scale in (1e-4, 1.0, 1e4):
        x = torch.from_numpy((scale * rng.standard_normal(1000)).astype(
            np.float32))
        q, s, pad = TC.quantize_fp8_block(x, BLOCK)
        back = TC.dequantize_fp8_block(q, s, pad, tuple(x.shape))
        blocks = torch.nn.functional.pad(x, (0, pad)).reshape(-1, BLOCK)
        amax = blocks.abs().amax(1).repeat_interleave(BLOCK)[:1000]
        assert torch.all((back - x).abs() <= amax * 2.0 ** -3 + 1e-30)


def test_zero_blocks_and_padding():
    x = torch.zeros(100)
    q, s, pad = TC.quantize_fp8_block(x, BLOCK)
    assert pad == 28 and torch.all(s == 1e-12)
    assert torch.all(q.float() == 0)
    y = torch.arange(1.0, 71.0)
    q, s, pad = TC.quantize_fp8_block(y, BLOCK)
    back = TC.dequantize_fp8_block(q, s, pad, (70,))
    assert back.shape == (70,) and pad == 58
    rq, rs, rpad = RC.quantize_fp8_block(jnp.asarray(y.numpy()), BLOCK)
    assert rpad == pad
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        RC.dequantize_fp8_block(rq, rs, rpad, (70,))))


def test_compressed_psum_equals_the_reference(both):
    _, _, port, ref = both
    top = np.abs(ref["sum"]).max()
    for r in range(4):  # every device holds the same sum
        assert np.abs(port["sum"] - ref["sum"][r]).max() <= 1e-6 * top
    etop = np.abs(ref["new_err"]).max()
    assert np.abs(port["new_err"] - ref["new_err"]).max() <= 1e-6 * etop


def test_compressed_sum_is_close_to_the_exact_sum(both):
    x, err, port, _ = both
    exact = (x + err).sum(0)
    rel = np.abs(port["sum"] - exact).max() / np.abs(exact).max()
    assert 0 < rel < 0.07


def test_apply_to_grads_is_per_leaf_with_error_feedback(both):
    x, _, port, _ = both
    a1, b1 = port["tree1"]
    ea1, eb1 = port["err1"]
    assert a1.shape == SHAPE and b1.shape == (3, 61)
    # round 1 from zero error: each rank's residual of its own x
    assert np.abs(ea1).max() > 0 and np.abs(eb1).max() > 0
    # round 2 carries round 1's error: the same as one psum with it
    np.testing.assert_array_equal(port["tree2_a"], port["one_a"])
    np.testing.assert_array_equal(port["err2_a"], port["one_err_a"])


def test_scale_is_a_true_division_by_a_tensor():
    """The scale's quotient amax / 448 is a true division on every
    device: the divisor a 0-d tensor on the codes' device (CUDA divides
    by a Python number as a multiply by its reciprocal).  The data make
    the two differ in most blocks, and the scales equal numpy's f32
    quotient bit for bit."""
    from torch.utils._python_dispatch import TorchDispatchMode

    divisors = []

    class Divisions(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket is torch.ops.aten.div:
                divisors.append(args[1])
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(3)
    x = (100 * rng.standard_normal((64, BLOCK))).astype(np.float32)
    with Divisions():
        _, s, _ = TC.quantize_fp8_block(torch.from_numpy(x), BLOCK)
    assert divisors and all(isinstance(d, torch.Tensor) for d in divisors)
    (fp8_max,) = [d for d in divisors if d.ndim == 0]
    assert fp8_max.item() == TC.FP8_MAX and fp8_max.device == s.device
    amax = np.abs(x).max(axis=1)
    true = amax / np.float32(TC.FP8_MAX)
    by_reciprocal = amax * (np.float32(1) / np.float32(TC.FP8_MAX))
    assert (true != by_reciprocal).sum() >= 8
    np.testing.assert_array_equal(s.numpy(), true)
