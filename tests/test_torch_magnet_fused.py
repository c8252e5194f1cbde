"""MagNetConv's fused path (``magnet_conv.fused_conv``) on the CPU: its
hand-written backward by float64 ``gradcheck`` on a segment-tier dual;
outputs and every gradient against autograd through the generic
recurrence (``dual_chebyshev_stacks``, the einsums, the complex ReLU) with
the same weights, on the kernel tier's plain versions (flat, and split and
streamed with the layout knobs lowered); the epilogue's plain versions;
and the counters: which models and tiers engage the fused path."""
import numpy as np
import pytest
import torch

from pytorch_geometric_signed_directed_tpu_torch.instrument import reset_counts
from pytorch_geometric_signed_directed_tpu_torch.nn import (
    MagNet_link_prediction, MagNet_node_classification,
    MSGNN_node_classification, complex_relu)
from pytorch_geometric_signed_directed_tpu_torch.nn.directed import (
    magnet_conv)
from pytorch_geometric_signed_directed_tpu_torch.ops import cuda, layout
from pytorch_geometric_signed_directed_tpu_torch.ops.cuda import (
    complex_epilogue as epi)
from pytorch_geometric_signed_directed_tpu_torch.spectral import (
    magnet_propagators, magnetic_template)
from pytorch_geometric_signed_directed_tpu_torch.train import masked_nll

from test_torch_worker_memory import release_memory  # noqa: F401

# float32, sums in other orders (the recurrence's adds taken into the
# products): the tolerance of the port's other float32 model tests
F32_TOL = dict(rtol=1e-4, atol=1e-5)


def assert_f32_close(got, want, msg=None):
    """Within float32 rounding of the tensor's scale: a weight gradient
    sums 2N products of terms whose recurrence cancels (T_2 = 2 P T_1 -
    T_0), so its small entries carry an error of a few ulp of its largest
    (both paths, measured against float64: up to 3e-7 of the largest)."""
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=2e-6 * float(want.detach().abs().max()),
                               msg=msg)


SPLIT_STREAM = dict(COL_SPLIT_MIN_COLS=100, GATHER_FAST_ROWS=64,
                    COL_SPLIT_MIN_COVERAGE=0.0, STREAM_THRESHOLD_EDGES=1000,
                    STREAM_BLOCK_EDGES=2048)


def graph(n, e, seed):
    rng = np.random.default_rng(seed)
    ei = np.vstack([rng.integers(0, n, e), (rng.zipf(1.3, e) - 1) % n])
    ei = ei[:, ei[0] != ei[1]]
    return ei, rng.uniform(0.5, 1.5, ei.shape[1])


def generic(x, weight, bias, D, K, activation):
    """The layer as autograd differentiates it on the generic path: the
    stacked recurrence, two einsums, the combine, the bias, the ReLU."""
    f = weight.shape[1]
    s1, s2 = magnet_conv.dual_chebyshev_stacks(D, x[:, :f], x[:, f:], K)
    o1 = torch.einsum("knf,kfo->no", s1, weight)
    o2 = torch.einsum("knf,kfo->no", s2, weight)
    re, im = o1 - o2, o1 + o2
    if bias is not None:
        re, im = re + bias, im + bias
    if activation:
        re, im = complex_relu(re, im)
    return torch.cat([re, im], dim=1)


def leaves(n, f_in, f_out, K, bias, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 2 * f_in, generator=g, dtype=dtype)
    w = torch.randn(K + 1, f_in, f_out, generator=g, dtype=dtype) / f_in
    b = torch.randn(f_out, generator=g, dtype=dtype) if bias else None
    return [t.requires_grad_() if t is not None else None for t in (x, w, b)]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", [True, False])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_fused_backward_gradcheck(K, activation, bias):
    n = 24
    ei, w = graph(n, 90, seed=K)
    D = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="segment",
                           device="cpu").dual
    # (2, 8): the concatenated operand, one product; (3, 2): a product a
    # term
    for f_in, f_out in ((2, 8), (3, 2)):
        x, wt, b = leaves(n, f_in, f_out, K, bias, torch.float64, seed=K)
        inputs = (x, wt) + ((b,) if bias else ())

        def fn(*a):
            return magnet_conv.fused_conv(a[0], a[1], a[2] if bias else None,
                                          D, activation)

        assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["segment", "flat", "split_streamed"])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_fused_matches_the_generic_recurrence(K, kind, monkeypatch):
    for k, v in (SPLIT_STREAM if kind == "split_streamed" else {}).items():
        monkeypatch.setattr(layout, k, v)
    n = 300
    ei, w = graph(n, 2500, seed=20 + K)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n,
                             mode="segment" if kind == "segment" else "mxu",
                             device="cpu")
    D = lap.dual
    if kind == "split_streamed":
        assert D.blocks and D.streamed and D.transposed.blocks
    for f_in, f_out, act in ((2, 16, True), (6, 5, True), (6, 5, False)):
        x, wt, b = leaves(n, f_in, f_out, K, True, torch.float32, seed=K)
        g = torch.randn(n, 2 * f_out, generator=torch.Generator()
                        .manual_seed(7))
        got = magnet_conv.fused_conv(x, wt, b, D, act)
        got_grads = torch.autograd.grad((got * g).sum(), (x, wt, b))
        want = generic(x, wt, b, D, K, act)
        want_grads = torch.autograd.grad((want * g).sum(), (x, wt, b))
        assert_f32_close(got, want)
        for name, a, e in zip("xwb", got_grads, want_grads):
            assert_f32_close(a, e, msg=name)


@pytest.mark.parametrize("f", [5, 8])
def test_epilogue_plain_versions(f):
    g = torch.Generator().manual_seed(f)
    y = torch.randn(37, 2 * f, generator=g)
    y[:5, :f] = y[:5, f:]                    # re = 0 exactly (no bias)
    dz = torch.randn(37, 2 * f, generator=g)
    for bias in (None, torch.randn(f, generator=g)):
        for act in (True, False):
            z, mask = epi.complex_epilogue(y, bias, act)
            y_ = y.clone().requires_grad_()
            b_ = bias.clone().requires_grad_() if bias is not None else None
            want = generic_epilogue(y_, b_, act)
            assert torch.equal(z, want)
            assert (mask is not None) == act
            uv, db = epi.complex_epilogue_backward(dz, mask, bias is not None)
            grads = torch.autograd.grad(
                (want * dz).sum(), (y_,) + ((b_,) if bias is not None else ()))
            assert torch.equal(uv, grads[0])
            if bias is not None:
                torch.testing.assert_close(db, grads[1], rtol=1e-6,
                                           atol=1e-6)
            else:
                assert db is None
    _, mask = epi.complex_epilogue(y, None, True)
    assert mask[:5].all()                    # re >= 0 at re == 0
    assert epi.complex_epilogue(y, None, True, keep_mask=False)[1] is None


def generic_epilogue(y, bias, activation):
    f = y.shape[1] // 2
    re, im = y[:, :f] - y[:, f:], y[:, :f] + y[:, f:]
    if bias is not None:
        re, im = re + bias, im + bias
    if activation:
        re, im = complex_relu(re, im)
    return torch.cat([re, im], dim=1)


def test_epilogue_plan():
    # F = 64: 16 float4 groups a row, 16 rows a CTA, at most 8 CTAs an SM
    assert epi.plan(2_388_953, 64, True, 132) == (4, 16, 8 * 132)
    assert epi.plan(100, 64, True, 132) == (4, 16, 7)
    # off a multiple of 4, or rows not 16-byte aligned: a lane a thread
    assert epi.plan(100, 5, True, 132) == (1, 8, 4)
    assert epi.plan(100, 64, False, 132) == (1, 64, 25)
    # wider than a CTA: 256 threads across, more CTAs along y
    assert epi.plan(10, 1500, True, 132) == (4, 256, 10)
    assert epi.bytes_moved(10, 64) == 10 * 17 * 64


def _step(model, lap, n, seed=0):
    """A training step, then the calls so far; then the evaluation
    forward."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, n))
    out = model(x, x, lap, True, torch.Generator().manual_seed(1))
    out = out[1] if isinstance(out, tuple) else out
    masked_nll(out, y, torch.ones(n)).backward()
    after_step = dict(magnet_conv.FUSED_CALLS)
    with torch.no_grad():
        model(x, x, lap)
    return after_step


MODEL_KW = dict(num_features=2, hidden=8, K=2, label_dim=3, activation=True,
                layer=2, dropout=0.5, device="cpu")


@pytest.mark.parametrize("case", ["magnet_mxu", "msgnn_segment",
                                  "trainable_q", "dense"])
def test_fused_counters(case):
    n = 120
    ei, w = graph(n, 600, seed=3)
    if case == "trainable_q":
        lap = magnetic_template(ei, w, num_nodes=n, mode="mxu", device="cpu")
    else:
        lap = magnet_propagators(
            ei, w, q=0.25, num_nodes=n, device="cpu",
            mode={"magnet_mxu": "mxu", "msgnn_segment": "segment"}.get(
                case, case))
    cls = (MSGNN_node_classification if case == "msgnn_segment"
           else MagNet_node_classification)
    model = cls(**MODEL_KW, trainable_q=case == "trainable_q",
                generator=torch.Generator().manual_seed(0))
    reset_counts()
    after_step = _step(model, lap, n)
    engaged = case in ("magnet_mxu", "msgnn_segment")
    # two layers: two fused forwards and two hand-written backwards in the
    # training step, two fused forwards in the evaluation
    assert after_step == ({"forward": 2, "backward": 2} if engaged
                          else {"forward": 0, "backward": 0})
    assert magnet_conv.FUSED_CALLS["forward"] == (4 if engaged else 0)
    # the CPU takes the plain versions: no launch
    assert set(epi.LAUNCHES.values()) == {0}
    assert not set(cuda.launch_counts()) & set(epi.LAUNCHES)


def test_link_prediction_takes_the_fused_path_and_matches():
    n = 100
    ei, w = graph(n, 500, seed=9)
    lap = magnet_propagators(ei, w, q=0.25, num_nodes=n, mode="mxu",
                             device="cpu")
    kw = dict(num_features=2, hidden=8, K=2, label_dim=2, activation=True,
              layer=2, device="cpu")
    model = MagNet_link_prediction(**kw,
                                   generator=torch.Generator().manual_seed(4))
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.random((n, 2)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, n, (40, 2)))
    unfused = type(lap)(lap.re, lap.im, None)    # the same pair, no dual
    reset_counts()
    got = model(x, x, lap, q)
    assert magnet_conv.FUSED_CALLS["forward"] == 2
    want = model(x, x, unfused, q)
    assert magnet_conv.FUSED_CALLS["forward"] == 2
    torch.testing.assert_close(got, want, **F32_TOL)
