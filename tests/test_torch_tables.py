"""The PyTorch port's constant tables equal the JAX package's originals.

The codec has no weights: these tables (cosines, zig-zag, transform
matrices, wavefront layout, DC-predictor kinds, header) are what the port
carries across, so each is held equal to the array it was copied from.
"""
import dataclasses

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest

from icspcodec_tpu import constants as jconst
from icspcodec_tpu import oracle as joracle
from icspcodec_tpu.config import CodecConfig as JConfig
from icspcodec_tpu.engine import wavefront as jwf
from icspcodec_tpu.ops import transforms as jtr
from icspcodec_torch import constants as tconst
from icspcodec_torch import tables
from icspcodec_torch.config import CodecConfig as TConfig


@pytest.mark.parametrize("name", ["COS_ENC", "COS_DEC", "IRT2", "ZIGZAG", "IZIGZAG"])
def test_constants_equal_jax(name):
    a, b = np.asarray(getattr(jconst, name)), np.asarray(getattr(tconst, name))
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("gh,gw", [(6, 8), (5, 7), (2, 2), (36, 44), (18, 22)])
def test_wavefront_tables_equal_jax(gh, gw):
    for ja, ta in zip(jwf.diag_layout(gh, gw), tables.diag_layout(gh, gw)):
        assert np.array_equal(np.asarray(ja), np.asarray(ta))
    for ja, ta in zip(jwf._intra_lane_tables(gh, gw), tables.intra_lane_tables(gh, gw)):
        assert np.array_equal(ja, ta)
    assert np.array_equal(jwf.luma_dc_kind(gh, gw), tables.luma_dc_kind(gh, gw))
    assert np.array_equal(jwf.chroma_dc_kind(gh, gw), tables.chroma_dc_kind(gh, gw))


@pytest.mark.parametrize("key", ["enc", "dec"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_transform_matrices_equal_jax(key, dtype):
    assert np.array_equal(jtr._fdct_matrix(key, dtype), tables.fdct_matrix(key, dtype))
    assert np.array_equal(jtr._idct_matrix(key, dtype), tables.idct_matrix(key, dtype))
    table = tconst.COS_ENC if key == "enc" else tconst.COS_DEC
    assert tables.table_key(table.copy()) == jtr._table_key(table.copy()) == key


def test_table_key_rejects_unknown_tables():
    with pytest.raises(ValueError):
        tables.table_key(tconst.COS_ENC * 2)


@pytest.mark.parametrize("args", [(288, 352, 16, 16, 0), (64, 96, 8, 16, 1),
                                  (720, 1280, 1, 31, 10), (144, 176, 10, 12, 63)])
def test_pack_header_equal_jax(args):
    assert tables.pack_header(*args) == joracle.pack_header(*args)


def test_config_equals_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert jf == tf
    cfg = dict(width=96, height=64, intra_period=0)
    assert TConfig(**cfg).grid == JConfig(**cfg).grid
    assert TConfig(**cfg).eff_period == JConfig(**cfg).eff_period == 1
    for bad in (dict(entropy="gpu"), dict(gop_shards=0), dict(tile_shards=5),
                dict(gop_shards=2, tile_shards=2)):
        with pytest.raises(ValueError):
            JConfig(**bad)
        with pytest.raises(ValueError):
            TConfig(**bad)
