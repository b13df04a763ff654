"""Port fused MBConv against the JAX package on the CPU.

- ``fold_block_params`` (port, reading a torch ``MBConvBlock``) against the
  JAX fold of the same flax variables: every folded leaf within 1e-6 (both
  fold in f32 with the same operations; the bound only covers the order of
  a product of three f32 values).
- ``fused_mbconv_plain`` against the Pallas kernel in interpret mode, on the
  JAX fold's own arrays, over the structural cases of
  ``tests/test_fused_mbconv.py`` and its Cmid-chunked grids. float32 is held
  at 2e-4 absolute plus relative, as the JAX test holds the kernel. bfloat16
  is held at 2e-2 absolute plus relative: the two sum the 1x1 products in
  another order, which can flip the bf16 rounding of one expanded or
  depthwise value (one bf16 step is 2^-8 relative) and of the output, and
  the output is itself bf16; a layout, padding or mask error moves outputs
  by O(1).
- the wrapper on CPU tensors takes the plain version and launches nothing,
  and refuses what the CUDA kernel does not take.

Every input and weight is made with numpy from a seed.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vbt_tpu.models.efficientnet_lite import MBConvArgs as JaxArgs  # noqa: E402
from vbt_tpu.models.efficientnet_lite import MBConvBlock as JaxBlock  # noqa: E402
from vbt_tpu.models.turbo import fold_block_params as jax_fold  # noqa: E402
from vbt_tpu.ops.fused_mbconv import fused_mbconv as jax_fused_mbconv  # noqa: E402
from vbt_tpu_torch.models.efficientnet_lite import MBConvArgs, MBConvBlock  # noqa: E402
from vbt_tpu_torch.models.turbo import fold_block_params  # noqa: E402
from vbt_tpu_torch.ops.fused_mbconv import (  # noqa: E402
    FusedBlockParams,
    fused_mbconv,
    fused_mbconv_plain,
)
from vbt_tpu_torch.runtime.checkpoint import convert_flax_variables, load_into  # noqa: E402

# (kernel, stride, expand, cin, cout, h): tests/test_fused_mbconv.py's cases.
SHAPES = [
    (3, 1, 6, 8, 8, 16),    # residual
    (3, 2, 6, 8, 16, 16),
    (5, 2, 6, 8, 16, 16),
    (5, 1, 6, 16, 16, 8),   # residual, k5
    (3, 1, 1, 8, 8, 16),    # no expand (stage-0 shape), residual
    (3, 2, 6, 8, 16, 10),   # 10 -> 5
]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _variables(kernel, stride, expand, cin, cout, h, seed=0):
    """Seeded numpy weights and BN statistics in the flax block's tree, and
    an NHWC input batch of 2."""
    block = JaxBlock(args=JaxArgs(kernel=kernel, stride=stride, expand=expand, out_ch=cout,
                                  repeats=1), stride=stride, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, h, cin)).astype(np.float32)
    shapes = jax.eval_shape(lambda: block.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    params = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.5).astype(np.float32),
                          shapes["params"])
    stats = jax.tree.map(lambda a: rng.uniform(0.1, 1.0, a.shape).astype(np.float32),
                         shapes["batch_stats"])
    return {"params": params, "batch_stats": stats}, x


def _port_block(variables, kernel, stride, expand, cin, cout):
    block = MBConvBlock(cin, MBConvArgs(kernel, stride, expand, cout, 1), stride)
    return load_into(block, convert_flax_variables(variables)).eval()


def _to_torch(fp, dtype) -> FusedBlockParams:
    """The JAX fold's arrays as the port's params (bf16 values carried exactly)."""
    def conv(a, dt=torch.float32):
        return None if a is None else torch.from_numpy(
            np.array(jnp.asarray(a, jnp.float32))).to(dt)

    return FusedBlockParams(we=conv(fp.we, dtype), be=conv(fp.be), wd=conv(fp.wd),
                            bd=conv(fp.bd), wp=conv(fp.wp, dtype), bp=conv(fp.bp), h=fp.h,
                            w=fp.w, kernel=fp.kernel, stride=fp.stride, residual=fp.residual)


def _both(shape, dtype, seed=0, num_chunks=None):
    """(port plain output, Pallas interpret output) as float32 numpy, (B, Cout, Ho*Wo)."""
    kernel, stride, expand, cin, cout, h = shape
    variables, x = _variables(*shape, seed=seed)
    residual = stride == 1 and cin == cout
    fp = jax_fold(variables["params"], variables["batch_stats"], h, h, kernel, stride,
                  residual, compute_dtype=JNP[dtype])
    x_cp = x.transpose(0, 3, 1, 2).reshape(2, cin, h * h)
    want = jax_fused_mbconv(jnp.asarray(x_cp, JNP[dtype]), fp, interpret=True,
                            num_chunks=num_chunks)
    got = fused_mbconv_plain(torch.from_numpy(x_cp).to(TORCH[dtype]), _to_torch(fp, TORCH[dtype]))
    assert got.dtype == TORCH[dtype]
    return got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))


@pytest.mark.parametrize("kernel,stride,expand,cin,cout,h", SHAPES)
def test_fold_block_params_matches_jax(kernel, stride, expand, cin, cout, h):
    variables, _ = _variables(kernel, stride, expand, cin, cout, h)
    residual = stride == 1 and cin == cout
    want = jax_fold(variables["params"], variables["batch_stats"], h, h, kernel, stride,
                    residual, compute_dtype=jnp.float32)
    block = _port_block(variables, kernel, stride, expand, cin, cout)
    got = fold_block_params(block, h, h, kernel, stride, residual, compute_dtype=torch.float32,
                            device="cpu")
    for name in ("we", "be", "wd", "bd", "wp", "bp"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0, err_msg=name)
    assert (got.h, got.w, got.kernel, got.stride, got.residual) == (h, h, kernel, stride, residual)
    assert got.has_expand == (expand != 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride,expand,cin,cout,h", SHAPES)
def test_plain_matches_pallas_interpret(dtype, kernel, stride, expand, cin, cout, h):
    got, want = _both((kernel, stride, expand, cin, cout, h), dtype)
    ho = -(-h // stride)
    assert got.shape == want.shape == (2, cout, ho * ho)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_chunks", [2, 3, 6])
def test_plain_matches_pallas_cmid_chunked(dtype, num_chunks):
    """The Pallas kernel's Cmid-chunked grid sums the same block; the port
    has no chunk argument, its kernel chunks inside one CTA."""
    got, want = _both((3, 2, 6, 8, 16, 16), dtype, seed=3, num_chunks=num_chunks)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def _cpu_case(dtype=torch.float32):
    """A ragged, non-square stride-2 block (9x7 -> 5x4) and its NCHW input."""
    rng = np.random.default_rng(5)
    cin, cmid, cout, h, w, k = 6, 36, 10, 9, 7, 3

    def r(*shape, dt=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dt)

    p = FusedBlockParams(we=r(cmid, cin, dt=dtype), be=r(cmid, 1), wd=r(cmid, k * k),
                         bd=r(cmid, 1), wp=r(cout, cmid, dt=dtype), bp=r(cout, 1), h=h, w=w,
                         kernel=k, stride=2, residual=False)
    return r(2, cin, h, w, dt=dtype), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_takes_plain_version(dtype):
    x, p = _cpu_case(dtype)
    before = fused_mbconv.launches
    got = fused_mbconv(x, p)  # NCHW input
    want = fused_mbconv_plain(x.reshape(2, 6, 63), p)  # the same bytes as (B, C, H*W)
    assert fused_mbconv.launches == before
    assert got.shape == (2, 10, 5 * 4) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("change", [
    {"kernel": 7, "wd": torch.zeros(36, 49)},
    {"stride": 3},
    {"residual": True},  # at stride 2
    {"h": 8},  # x no longer has H*W positions
    {"bd": torch.zeros(35, 1)},
])
def test_wrapper_refuses_what_the_kernel_cannot_take(change):
    x, p = _cpu_case()
    with pytest.raises(ValueError):
        fused_mbconv(x, dataclasses.replace(p, **change))


def test_wrapper_refuses_mixed_dtypes():
    x, p = _cpu_case(torch.float32)
    with pytest.raises(TypeError):
        fused_mbconv(x.to(torch.bfloat16), p)
