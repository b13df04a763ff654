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
- ``launch_plan`` over every block the turbo backbone fuses for lite0 at
  320, lite1 at 384 and lite2 at 448 (walked from ``scaled_blocks`` with the
  backbone's fuse rule) and over the odd blocks the card script holds, in
  bfloat16 and float32: the variant is the documented one, the shared memory
  fits a block, the chunk covers Cmid, Cout is within the accumulators, and
  the tiles cover the output exactly once.

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
from vbt_tpu_torch.models.efficientnet_lite import (  # noqa: E402
    STEM_CHANNELS,
    MBConvArgs,
    MBConvBlock,
    scaled_blocks,
)
from vbt_tpu_torch.models.turbo import FUSE_MIN_SPATIAL, fold_block_params  # noqa: E402
from vbt_tpu_torch.ops.fused_mbconv import (  # noqa: E402
    MAX_SMEM,
    FusedBlockParams,
    fused_mbconv,
    fused_mbconv_plain,
    launch_plan,
    mma_takes,
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


def _fused_shapes(variant: str, size: int):
    """(name, cin, cmid, cout, h, w, kernel, stride, has_expand) of the blocks
    the turbo backbone fuses at a ``size`` x ``size`` input: an expand conv
    and an input of at least ``FUSE_MIN_SPATIAL`` positions."""
    h = -(-size // 2)  # after the stride-2 stem
    cin = STEM_CHANNELS
    out = []
    for gi, args in enumerate(scaled_blocks(variant)):
        for bi in range(args.repeats):
            stride = args.stride if bi == 0 else 1
            if h * h >= FUSE_MIN_SPATIAL and args.expand != 1:
                out.append((f"{variant}_g{gi}_b{bi}", cin, cin * args.expand, args.out_ch, h, h,
                            args.kernel, stride, True))
            cin = args.out_ch
            if stride == 2:
                h = -(-h // 2)
    return out


# The odd blocks the card script holds: ragged channels, non-square odd sizes,
# no expand, and more input channels than the "mma" kernel's three k-steps.
ODD_SHAPES = [
    ("odd_s2_k5", 5, 37, 7, 37, 23, 5, 2, True),
    ("odd_s1_k3_residual", 24, 144, 24, 19, 45, 3, 1, True),
    ("odd_no_expand", 16, 16, 16, 21, 13, 3, 1, False),
    ("odd_cin56", 56, 96, 24, 17, 11, 3, 2, True),
    ("odd_cin64_residual", 64, 96, 64, 17, 11, 3, 1, True),
]
PLAN_SHAPES = (_fused_shapes("lite0", 320) + _fused_shapes("lite1", 384)
               + _fused_shapes("lite2", 448) + ODD_SHAPES)


def test_fused_shapes_are_the_backbones():
    """The walk above names the blocks ``TurboBackbone`` fuses: 5 for lite0, 7 for lite2."""
    assert [s[0] for s in _fused_shapes("lite0", 320)] == [
        "lite0_g1_b0", "lite0_g1_b1", "lite0_g2_b0", "lite0_g2_b1", "lite0_g3_b0"]
    assert _fused_shapes("lite0", 320)[0][1:] == (16, 96, 24, 160, 160, 3, 2, True)
    assert _fused_shapes("lite0", 320)[4][1:] == (40, 240, 80, 40, 40, 3, 2, True)
    assert len(_fused_shapes("lite2", 448)) == 7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[s[0] for s in PLAN_SHAPES])
def test_launch_plan(shape, dtype):
    name, cin, cmid, cout, h, w, kernel, stride, has_expand = shape
    plan = launch_plan(dtype, cin, cmid, cout, h, w, kernel, stride, has_expand)
    # The documented rule: bfloat16 blocks with an expand conv, Cin (at most
    # 48) and Cout multiples of 8 and Cmid a multiple of 48 go to "mma", all
    # else to "fma".
    regular = (has_expand and cin % 8 == 0 and cin <= 48 and cout % 8 == 0
               and cmid % 48 == 0)
    want = "mma" if dtype == torch.bfloat16 and regular else "fma"
    assert plan.variant == want
    assert mma_takes(dtype, cin, cmid, cout, has_expand) == (want == "mma")
    if not name.startswith("odd"):
        assert regular  # every fused block of lite0, lite1 and lite2 is served by "mma" in bf16
    assert 0 < plan.smem_bytes <= MAX_SMEM == 232448
    assert plan.threads % 32 == 0 and 0 < plan.threads <= 1024
    assert plan.chunk * -(-cmid // plan.chunk) >= cmid
    if plan.variant == "mma":
        assert cmid % plan.chunk == 0  # the tensor-core kernel has no ragged chunk
        assert plan.tile_h * plan.tile_w % 16 == 0  # whole m-tiles of the projection
    assert cout <= plan.max_cout
    # The tiles cover every output position exactly once.
    ho, wo = -(-h // stride), -(-w // stride)
    covered = np.zeros((ho, wo), np.int32)
    for y, x in plan.tile_origins(ho, wo):
        covered[y:y + plan.tile_h, x:x + plan.tile_w] += 1
    assert (covered == 1).all()
    # A named variant is taken as asked where the block allows it.
    assert launch_plan(dtype, cin, cmid, cout, h, w, kernel, stride, has_expand,
                       variant="fma").variant == "fma"
    if want == "mma":
        assert launch_plan(dtype, cin, cmid, cout, h, w, kernel, stride, has_expand,
                           variant="mma") == plan
    else:
        with pytest.raises(ValueError):
            launch_plan(dtype, cin, cmid, cout, h, w, kernel, stride, has_expand, variant="mma")


def test_launch_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError):
        launch_plan(torch.bfloat16, 24, 144, 24, 80, 80, 3, 1, variant="wgmma")
    with pytest.raises(ValueError):  # more output channels than either kernel accumulates
        launch_plan(torch.float32, 24, 144, 136, 80, 80, 3, 1)
    with pytest.raises(ValueError):  # f32 tiles of 512 input channels do not fit a block
        launch_plan(torch.float32, 512, 3072, 64, 80, 80, 5, 2)


@pytest.mark.parametrize("variant", ["mma", "fma"])
def test_wrapper_variant_on_cpu(variant):
    """On the CPU a named variant runs the plain version, but the launch
    plan's rule still decides whether the block may have it."""
    x, p = _cpu_case(torch.bfloat16)  # 6 -> 36 -> 10 channels: ragged, so "fma" only
    if variant == "mma":
        with pytest.raises(ValueError):
            fused_mbconv(x, p, variant=variant)
    else:
        assert torch.equal(fused_mbconv(x, p, variant=variant), fused_mbconv_plain(x, p))
    with pytest.raises(ValueError):
        fused_mbconv(x, p, variant="cudnn")


def test_wrapper_on_cpu_takes_channels_last_input():
    """A channels-last NCHW tensor holds the same values: the plain version gives the same."""
    x, p = _cpu_case(torch.bfloat16)
    got = fused_mbconv(x.contiguous(memory_format=torch.channels_last), p)
    assert torch.equal(got, fused_mbconv_plain(x, p))
