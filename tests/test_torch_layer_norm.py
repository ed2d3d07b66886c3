"""The net's LayerNorm (S2, ``ops/layer_norm.py``): its plain forward and
backward against flax's ``nn.LayerNorm`` with the net's epilogues, on the
CPU.

Inputs are drawn with numpy from a seed and given to both: rows of C
channels (C = 8-256, every width the kernels take) in NHWC activations of
a small board, float32 or bfloat16, the parameters float32.  The epilogues
are the JAX net's (``twixt_for_open_spiel_tpu/models/network.py``): none,
``nn.relu`` after the norm, and ``ResBlock``'s ``nn.relu(x + y)``.

Tolerances (``scale`` = max(1, max |flax|) of each output):

  * float32: 1e-5 * scale, forward and backward: both compute flax's
    formula in float32, summing the statistics in another order;
  * bfloat16 activations: 2**-6 * scale, two bf16 ulps of the output's
    scale: y is rounded to bf16 after float32 sums taken in another order,
    so it may land one ulp apart, and the residual epilogue rounds twice;
    the parameters' gradients stay float32 and keep 1e-5.

Also: ``torch.autograd.gradcheck`` of the autograd function's plain path
in float64; a net on the CPU launches no S2 kernel; ``create_net``'s
parameter names and shapes; the wrapper's checks; and a numpy model of
the kernels' row layout and of S2b's deterministic partial sums (the CUDA
kernels run only on the card, where ``chip_smoke.py`` holds them to the
plain version).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twixt_for_open_spiel_tpu_torch import profile_search
from twixt_for_open_spiel_tpu_torch.models import network as tnet
from twixt_for_open_spiel_tpu_torch.ops import layer_norm as tln

torch.set_num_threads(1)

SHAPE = (2, 3, 4)  # batch, rows, columns of the NHWC activations: 24 rows
EPILOGUES = (None, "relu", "residual")
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2.0**-6}
PARAM_TOL = 1e-5


CASES = [(c, kind, epi) for c in tln.CHANNELS for kind in DTYPES for epi in EPILOGUES]


def case_id(case):
    c, kind, epi = case
    return f"C{c}-{kind}-{epi}"


def forward_draw(case) -> dict:
    c, _, epi = case
    return draw(c, seed=c + 7 * EPILOGUES.index(epi))


def backward_draw(case) -> dict:
    c, _, epi = case
    return draw(c, seed=100 + c + 7 * EPILOGUES.index(epi))


def draw(c: int, seed: int) -> dict:
    """numpy inputs of one case: x, residual and dout over SHAPE + (c,), the
    scale and bias; x off zero mean, as a convolution's output is."""
    rng = np.random.default_rng(seed)
    shape = SHAPE + (c,)
    return {"x": rng.normal(0.3, 1.2, shape).astype(np.float32),
            "res": rng.normal(0.0, 1.0, shape).astype(np.float32),
            "dout": rng.normal(0.0, 1.0, shape).astype(np.float32),
            "scale": rng.normal(1.0, 0.3, c).astype(np.float32),
            "bias": rng.normal(0.0, 0.3, c).astype(np.float32)}


def flax_fn(epilogue, jdtype):
    """(x, scale, bias, res) -> the JAX net's norm and epilogue."""
    norm = fnn.LayerNorm(dtype=jdtype)

    def fn(x, scale, bias, res):
        y = norm.apply({"params": {"scale": scale, "bias": bias}}, x)
        if epilogue == "residual":
            return fnn.relu(res + y)
        return fnn.relu(y) if epilogue == "relu" else y
    return fn


@functools.cache
def flax_records(kind: str) -> dict:
    """JAX's results for every case of one dtype, from one jit (one compile
    rather than one a case): case id -> (out, mean, var) of the forward's
    inputs and the cotangents of (x, scale, bias, res) for the backward's."""
    jdtype = DTYPES[kind][1]
    cases = [case for case in CASES if case[1] == kind]

    def run(fwd_inputs, bwd_inputs):
        out = {}
        for case, fwd, (dout, *bwd) in zip(cases, fwd_inputs, bwd_inputs):
            fn = flax_fn(case[2], jdtype)
            out[case_id(case)] = (fn(*fwd),
                                  *fnn.normalization._compute_stats(fwd[0], (-1,), None),
                                  jax.vjp(fn, *bwd)[1](dout))
        return out

    fwd = [jax_inputs(forward_draw(case), jdtype) for case in cases]
    bwd = [(jnp.asarray(d["dout"]).astype(jdtype), *jax_inputs(d, jdtype))
           for d in map(backward_draw, cases)]
    return jax.jit(run)(fwd, bwd)


def jax_inputs(case, jdtype):
    return (jnp.asarray(case["x"]).astype(jdtype), jnp.asarray(case["scale"]),
            jnp.asarray(case["bias"]), jnp.asarray(case["res"]).astype(jdtype))


def torch_inputs(case, dtype):
    return (torch.from_numpy(case["x"]).to(dtype), torch.from_numpy(case["scale"]),
            torch.from_numpy(case["bias"]), torch.from_numpy(case["res"]).to(dtype))


def to_np(t) -> np.ndarray:
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t.astype(jnp.float32))


def assert_close(got, want, rel, what):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} * {scale}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_matches_flax(case):
    c, kind, epi = case
    dtype, jdtype = DTYPES[kind]
    inputs = forward_draw(case)
    want, mu, var, _ = flax_records(kind)[case_id(case)]
    x, w, b, res = torch_inputs(inputs, dtype)
    res = res if epi == "residual" else None
    out = tln.layer_norm_reference(x, w, b, epi, res)
    mean, rstd = tln.layer_norm_stats(x)
    assert out.dtype == dtype and mean.dtype == rstd.dtype == torch.float32
    assert_close(out, want, TOL[kind], f"forward C={c} {kind} {epi}")
    # the entry point on CPU tensors is the plain version
    assert torch.equal(tln.layer_norm(x, w, b, epi, res), out)
    # the statistics are flax's, in float32
    np.testing.assert_allclose(mean.numpy(), np.asarray(mu), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(np.asarray(var) + tln.LN_EPS),
                               rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_backward_matches_jax_vjp(case):
    c, kind, epi = case
    dtype, jdtype = DTYPES[kind]
    inputs = backward_draw(case)
    want_dx, want_dw, want_db, want_dres = flax_records(kind)[case_id(case)][3]

    x, w, b, res = (t.requires_grad_() for t in torch_inputs(inputs, dtype))
    out = tln.layer_norm(x, w, b, epi, res if epi == "residual" else None)
    out.backward(torch.from_numpy(inputs["dout"]).to(dtype))
    assert x.grad.dtype == dtype and w.grad.dtype == b.grad.dtype == torch.float32
    what = f"backward C={c} {kind} {epi}"
    assert_close(x.grad, want_dx, TOL[kind], what + " dx")
    assert_close(w.grad, want_dw, PARAM_TOL, what + " dscale")
    assert_close(b.grad, want_db, PARAM_TOL, what + " dbias")
    if epi == "residual":
        assert res.grad.dtype == dtype
        assert_close(res.grad, want_dres, 0.0, what + " dres")
    else:
        assert res.grad is None


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_gradcheck_plain_path(epilogue):
    rng = np.random.default_rng(3 + EPILOGUES.index(epilogue))
    c = 8
    x, res = (torch.from_numpy(rng.normal(0.2, 1.0, (3, c))).requires_grad_() for _ in range(2))
    w = torch.from_numpy(rng.normal(1.0, 0.3, c)).requires_grad_()
    b = torch.from_numpy(rng.normal(0.0, 0.3, c)).requires_grad_()
    if epilogue == "residual":
        args = (x, w, b, res)
        fn = lambda x, w, b, r: tln.layer_norm(x, w, b, epilogue, r)  # noqa: E731
    else:
        args = (x, w, b)
        fn = lambda x, w, b: tln.layer_norm(x, w, b, epilogue)  # noqa: E731
    assert fn(*args).dtype == torch.float64
    # the ReLU's argument keeps off its kink by far more than the step
    pre = tln.layer_norm(x, w, b) + (res if epilogue == "residual" else 0)
    assert bool((pre.abs() > 1e-3).all())
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_backward_mask_is_the_forwards(epilogue, kind):
    """The backward takes the forward's inputs and computes its ReLU mask
    again: the same gradients as when it is given the forward's output,
    also where a row's y lands exactly on 0 (a constant row's y is the
    bias)."""
    dtype = DTYPES[kind][0]
    d = draw(32, seed=40 + EPILOGUES.index(epilogue))
    x, w, b, res = torch_inputs(d, dtype)
    x[0, 0, 0] = 0.5  # a constant row: var 0, y = bias
    b[::4] = 0.0
    res = res if epilogue == "residual" else None
    dout = torch.from_numpy(d["dout"]).to(dtype)
    out = tln.layer_norm_reference(x, w, b, epilogue, res)
    again = tln.layer_norm_backward(dout, x, w, b, epilogue, res)
    given = tln.layer_norm_backward_reference(dout, x, w, b, epilogue, res, out=out)
    for got, want in zip(again, given):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


def test_cpu_net_launches_no_kernel():
    before = (tln.layer_norm_forward.launches, tln.layer_norm_backward.launches)
    net = tnet.create_net(5, channels=8, blocks=1, device="cpu")
    obs = torch.from_numpy(np.random.default_rng(0).random((4, 12, 5, 3)).astype(np.float32))
    logits, value = net(obs)
    (logits.sum() + value.sum()).backward()
    assert all(p.grad is not None for p in net.parameters())
    assert (tln.layer_norm_forward.launches, tln.layer_norm_backward.launches) == before == (0, 0)


def expected_names(channels: int, blocks: int, n: int = 12) -> dict:
    """The net's parameter names and shapes, as they were before S2."""
    cells = n * (n - 2)
    shapes = {"stem.weight": (channels, 12, 3, 3), "stem.bias": (channels,),
              "stem_norm.weight": (channels,), "stem_norm.bias": (channels,)}
    for i in range(blocks):
        for j in range(2):
            shapes[f"blocks.{i}.conv{j}.weight"] = (channels, channels, 3, 3)
            shapes[f"blocks.{i}.conv{j}.bias"] = (channels,)
            shapes[f"blocks.{i}.norm{j}.weight"] = (channels,)
            shapes[f"blocks.{i}.norm{j}.bias"] = (channels,)
    for head, layers in (("policy", {"out": (n * n, 32 * cells)}),
                         ("value", {"hidden": (256, 32 * cells), "hidden_norm": (256,),
                                    "out": (1, 256)})):
        shapes[f"{head}_conv.weight"] = (32, channels, 1, 1)
        shapes[f"{head}_conv.bias"] = (32,)
        shapes[f"{head}_norm.weight"] = (32,)
        shapes[f"{head}_norm.bias"] = (32,)
        for name, shape in layers.items():
            shapes[f"{head}_{name}.weight"] = shape
            shapes[f"{head}_{name}.bias"] = shape[:1]
    return shapes


@pytest.mark.parametrize("width", [(128, 6), (64, 4)], ids=["128x6", "64x4"])
def test_parameter_names_unchanged(width):
    got = {k: tuple(v.shape) for k, v in tnet.create_net(12, *width, device="cpu")
           .state_dict().items()}
    want = expected_names(*width)
    assert list(got) == list(want)
    assert got == want


def test_wrapper_checks():
    x = torch.zeros(4, 48)
    w, b = torch.ones(48), torch.zeros(48)
    with pytest.raises(ValueError, match="48 channels"):
        tln._check_rows(x)
    with pytest.raises(ValueError, match="dtype"):
        tln._check_rows(torch.zeros(4, 32, dtype=torch.float16))
    with pytest.raises(ValueError, match="residual"):
        tln.layer_norm(x, w, b, "relu", residual=x)
    with pytest.raises(ValueError, match="residual"):
        tln.layer_norm(x, w, b, "residual")
    with pytest.raises(ValueError, match="epilogue"):
        tln.layer_norm(x, w, b, "gelu")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tln.layer_norm(x.to("meta"), w.to("meta"), b.to("meta"))
    odd = torch.zeros(4 * 32 + 1)[1:].view(4, 32)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="aligned"):
        tln._pointers(odd, (odd,), ())
    with pytest.raises(ValueError, match="aligned"):
        tln._pointers(x, (x.t().contiguous().t(),), ())
    with pytest.raises(ValueError, match="must be"):
        tln._pointers(x, (), (w.double(),))
    with pytest.raises(ValueError, match="must be"):
        tln._pointers(x, (x[:2],), ())
    assert tln._pointers(x, (x, None), (w, b)) == [x.data_ptr(), None, w.data_ptr(),
                                                   b.data_ptr()]


@pytest.mark.parametrize("name, label", [
    ("void (anonymous namespace)::layer_norm_forward_kernel<__nv_bfloat16, 128, 2>"
     "(const __nv_bfloat16 *, const float *, const float *, const __nv_bfloat16 *, "
     "__nv_bfloat16 *, float *, float *, long long)", "S2a layer_norm forward"),
    ("void (anonymous namespace)::layer_norm_backward_kernel<float, 256, 0>(...)",
     "S2b layer_norm backward"),
    ("void (anonymous namespace)::layer_norm_forward_kernel<float, 64>(const float *, "
     "const float *, const float *, const float *, float *, long long, int)",
     "S2a layer_norm forward"),
    ("void (anonymous namespace)::layer_norm_backward_kernel<__nv_bfloat16, 64>(...)",
     "S2b layer_norm backward"),
    ("void (anonymous namespace)::layer_norm_param_grad_kernel(const float *, int, int, "
     "float *, float *)", "S2b layer_norm backward"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(...)",
     "library layer_norm forward"),
    ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernel<float, float>(...)",
     "library layer_norm backward"),
])
def test_profilers_name_the_kernels(name, label):
    """The profilers' class table attributes S2's kernels by their names."""
    assert profile_search.kernel_class(name) == label


# --- a numpy model of the kernels' layout (csrc/layer_norm.cu) --------------
THREADS, WARP = 256, 32


def layout(itemsize: int, c: int) -> tuple:
    """``Rows<T, C>``: (V elements a 16-byte vector, LANES a row, ITEMS
    vectors a lane, PER_BLOCK rows a block)."""
    v = 16 // itemsize
    lanes = min(c // v, WARP)
    return v, lanes, c // (lanes * v), THREADS // lanes


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", tln.CHANNELS)
def test_kernel_layout_covers_each_channel_once(itemsize, c):
    v, lanes, items, per_block = layout(itemsize, c)
    assert WARP % lanes == 0 and lanes * v * items == c and per_block * lanes == THREADS
    seen = sorted((k * lanes + sub) * v + j
                  for sub in range(lanes) for k in range(items) for j in range(v))
    assert seen == list(range(c))
    # a warp's 32 / lanes rows are neighbours: one contiguous span of bytes
    assert (WARP // lanes) * c * itemsize == WARP * 16 * items


@pytest.mark.parametrize("rows, c, max_blocks", [(1000, 32, 3), (24, 8, 1024), (70, 256, 2)])
def test_partial_sums_model(rows, c, max_blocks):
    """S2b's dgamma and dbeta in the kernel's order (each row group's rows in
    grid-stride turns, the groups in order, the blocks by lane and a shuffle
    tree), in float32, against the plain version."""
    rng = np.random.default_rng(rows)
    dy = rng.normal(size=(rows, c)).astype(np.float32)
    xh = rng.normal(size=(rows, c)).astype(np.float32)
    per_block = layout(2, c)[3]
    blocks = min(-(-rows // per_block), max_blocks)
    part = np.zeros((2, blocks, c), np.float32)
    visits = np.zeros(rows, int)
    for blk in range(blocks):
        acc = np.zeros((2, per_block, c), np.float32)
        for first in range(blk * per_block, rows, blocks * per_block):
            for grp in range(per_block):
                if first + grp < rows:
                    visits[first + grp] += 1
                    acc[0, grp] += dy[first + grp] * xh[first + grp]
                    acc[1, grp] += dy[first + grp]
        for grp in range(per_block):
            part[:, blk] += acc[:, grp]
    assert (visits == 1).all()
    lanes = np.zeros((2, WARP, c), np.float32)
    for q in range(blocks):
        lanes[:, q % WARP] += part[:, q]
    o = WARP // 2
    while o:
        lanes = lanes + lanes[:, np.arange(WARP) ^ o]
        o //= 2
    got = lanes[:, 0]
    want = [(torch.from_numpy(dy) * torch.from_numpy(xh)).sum(0), torch.from_numpy(dy).sum(0)]
    for g, w in zip(got, want):
        assert_close(g, w.numpy(), PARAM_TOL, "partials")
