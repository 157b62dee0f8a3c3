"""The JAX package's remaining public functions in the PyTorch port, against
the JAX originals on the same numpy-seeded inputs (frames of at most
64x96), and a name-parity check of the two packages.

* ops/me: spiral_search_fixed and spiral_search_union, on content with no
  zero SAD and on static-trigger content (chip_smoke.static_trigger_input),
  where the walk breaks early and the union branch decides;
* ops/quant.quant_scalar in float32 and float64, luma and chroma rounding,
  on negative and half-integer values;
* bitstream.pack_items on seeded items of 1-56 bits, one stream ending
  byte-aligned (the reference's extra zero byte);
* ops/mc_fused: best_from_mv / best_from_mv_union (an MV outside the
  table included) and the four mc_select_* wrappers against JAX
  gather_pred at the MVs -offsets[idx] (the plain version the JAX package
  holds its Pallas _mc_select against);
* parallel: gop_mesh and tile_mesh_for over device lists.

Everything compared is integer or a byte string: equality is exact.  The
name-parity test reads the JAX package's sources with ast (no JAX import)
and asserts that the port's module of the same path has every top-level
public function, class and constant.
"""
import ast
import functools
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from icspcodec_tpu import bitstream as jbs
from icspcodec_tpu.engine import intra as jintra
from icspcodec_tpu.ops import me as jme
from icspcodec_tpu.ops import pallas_me as jpme
from icspcodec_tpu.ops import quant as jquant
from icspcodec_torch import bitstream as tbs
from icspcodec_torch import tables
from icspcodec_torch.ops import mc_fused, me as tme
from icspcodec_torch.ops import pad as tpad
from icspcodec_torch.ops import quant as tquant
from icspcodec_torch.parallel import gop, tiles

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "icspcodec_tpu"

# The JAX Pallas modules have no module of their name in the port: their
# kernels became ops/*_fused.py and their numpy tables tables.py.
PALLAS = {
    "ops/pallas_dc.py": ("ops.dc_fused",),
    "ops/pallas_intra.py": ("ops.intra_fused", "ops.intra_decode_fused"),
    "ops/pallas_me.py": ("ops.me_fused", "ops.mc_fused", "tables"),
    "ops/pallas_xform.py": ("ops.xform_fused",),
}


def _search_frames(kind: str):
    """(cur (2, 64, 96) uint8, the two previous frames padded by 16) as
    tensors; the port's padding is held to the JAX package's in
    test_torch_mc.py::test_pad_image_matches_jax."""
    if kind == "static":
        y = chip_smoke.static_trigger_input()[0]
    else:
        y = np.random.default_rng(3).integers(0, 256, (3, 64, 96), dtype=np.uint8)
    return torch.from_numpy(y[1:3]), tpad.pad_image(torch.from_numpy(y[:2]), 16)


@functools.lru_cache(maxsize=None)
def _jax_search(name: str, cur, pad):
    """JAX's search `name` compiled once for the frames' shapes, at XLA's
    lowest backend optimisation level: the same integer results, a
    third less compile time."""
    return jax.jit(getattr(jme, name)).lower(cur, pad).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("kind", ["noise", "static"])
def test_spiral_searches_match_jax(kind):
    ct, pt = _search_frames(kind)
    cur, pad = jnp.asarray(ct.numpy()), jnp.asarray(pt.numpy())
    shapes = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in (cur, pad))
    zc = (tme.sad_dense(ct, pt, tme.SPIRAL) == 0).sum(dim=-3)
    # the union branch decides only where a walk breaks (two zero SADs)
    assert bool((zc >= 2).any()) == (kind == "static")

    fixed = tme.spiral_search_fixed(ct, pt)
    jf = np.asarray(_jax_search("spiral_search_fixed", *shapes)(cur, pad))
    assert fixed.dtype == torch.int32 and np.array_equal(fixed.numpy(), jf)

    mv_u, best_u = tme.spiral_search_union(ct, pt)
    jmv, jbest = (np.asarray(a) for a in _jax_search("spiral_search_union", *shapes)(cur, pad))
    assert mv_u.dtype == best_u.dtype == torch.int32
    assert np.array_equal(mv_u.numpy(), jmv) and np.array_equal(best_u.numpy(), jbest)
    # the hybrid takes the union result, which equals the fixed one
    # where no walk breaks
    assert torch.equal(tme.spiral_search(ct, pt), mv_u)
    if kind == "noise":
        assert torch.equal(fixed, mv_u)


@pytest.mark.parametrize("qstep", [1, 7, 16])
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("prec", ["float32", "float64"])
def test_quant_scalar_matches_jax(prec, chroma, qstep):
    rng = np.random.default_rng(qstep)
    v = np.concatenate([np.arange(-40, 41) / 2.0,                       # every half-integer
                        rng.normal(0, 300, 200).round(1),
                        np.round(rng.uniform(-3000, 3000, 100)) - 0.5]).astype(prec)
    j = np.asarray(jquant.quant_scalar(jnp.asarray(v), qstep, chroma))
    t = tquant.quant_scalar(torch.from_numpy(v), qstep, chroma)
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), j)


@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_items_matches_jax(seed, aligned):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 57, 400).astype(np.int64)
    tail = int(lengths.sum()) % 8
    if aligned:
        lengths[-1] += -tail if lengths[-1] > tail else 8 - tail
    elif not tail:
        lengths[-1] += -1 if lengths[-1] > 1 else 1
    assert (int(lengths.sum()) % 8 == 0) == aligned
    codes = rng.integers(0, 2 ** 63, 400, dtype=np.uint64) >> (64 - lengths).astype(np.uint64)
    got = tbs.pack_items(codes, lengths)
    assert got == jbs.pack_items(codes, lengths)
    assert len(got) == int(lengths.sum()) // 8 + 1


@pytest.mark.parametrize("table", ["spiral", "union"])
def test_best_from_mv_matches_jax(table):
    rng = np.random.default_rng(4)
    neg = tables.NEG_SPIRAL if table == "spiral" else tables.NEG_UNION
    mv = neg[rng.integers(0, len(neg), (2, 4, 6))]
    mv[0, 0, 0] = (57, -33)          # outside the table: index 0, as in JAX
    tfn, jfn = ((mc_fused.best_from_mv, jpme.best_from_mv) if table == "spiral"
                else (mc_fused.best_from_mv_union, jpme.best_from_mv_union))
    t = tfn(torch.from_numpy(mv))
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), np.asarray(jfn(jnp.asarray(mv))))
    assert int(t[0, 0, 0]) == 0
    ok = np.ones(mv.shape[:-1], bool)
    ok[0, 0, 0] = False
    assert np.array_equal(neg[t.numpy()][ok], mv[ok])


@functools.lru_cache(maxsize=None)
def _jax_gather(block: int):
    """JAX gather_pred as planes, one program a block size."""
    return jax.jit(lambda pad, mv: jintra.from_blocks(jme.gather_pred(pad, mv, block)))


@pytest.mark.parametrize("name,neg,block", [
    ("mc_select_luma", jpme.NEG_SPIRAL, 16),
    ("mc_select_chroma", -jpme.CHROMA_OFFSETS, 8),
    ("mc_select_luma_union", jpme.NEG_UNION, 16),
    ("mc_select_chroma_union", -jpme.CHROMA_U_OFFSETS, 8),
])
def test_mc_select_wrappers_match_the_pallas_kernel(name, neg, block):
    """Against JAX gather_pred at the MVs -offsets[idx]: the plain version
    the JAX package's own tests hold its Pallas _mc_select against
    (tests/test_ops.py), without an interpret-mode compile a case."""
    rng = np.random.default_rng(len(neg))
    img = rng.integers(0, 256, (2, 2 * block, 3 * block), dtype=np.uint8)
    pad = tpad.pad_image(torch.from_numpy(img), block)
    idx = rng.integers(0, len(neg), (2, 2, 3)).astype(np.int32)
    j = np.asarray(_jax_gather(block)(pad.numpy(), np.asarray(neg, np.int32)[idx]))
    t = getattr(mc_fused, name)(pad, torch.from_numpy(idx))
    assert t.dtype == torch.uint8 and np.array_equal(t.numpy(), j)


def test_mesh_constructors():
    cpu2 = [torch.device("cpu")] * 2
    assert gop.gop_mesh(["cpu"] * 2) == cpu2
    assert tiles.tile_mesh_for(2, ["cpu"] * 3) == cpu2
    with pytest.raises(ValueError, match="tile_shards=3"):
        tiles.tile_mesh_for(3, ["cpu"] * 2)
    with pytest.raises(ValueError):
        gop.gop_mesh([])


def _public_names(path: pathlib.Path) -> list[str]:
    """Top-level public functions, classes and assigned constants."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for e in target.elts if isinstance(target, ast.Tuple) else [target]:
                    if isinstance(e, ast.Name):
                        names.append(e.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py")
                     if _public_names(p))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_every_public_name_of_the_jax_module(rel):
    paths = PALLAS.get(rel) or (rel[:-3].replace("/", ".").removesuffix(".__init__"),)
    ports = [importlib.import_module(f"icspcodec_torch.{p}") for p in paths]
    # no name is exempt: the port has every public name of the JAX package
    missing = [n for n in _public_names(JAX_PKG / rel) if not any(hasattr(m, n) for m in ports)]
    assert not missing, f"{rel}: the port's {', '.join(paths)} lack {missing}"


def test_name_parity_covers_the_package():
    assert len(JAX_MODULES) >= 25
    assert "engine/wavefront.py" in JAX_MODULES and "ops/pallas_me.py" in JAX_MODULES
