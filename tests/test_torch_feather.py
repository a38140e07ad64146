"""The port's feather (Arrow IPC) reader against pyarrow on files pandas
writes, and its schema helpers against the JAX package's."""

import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow.ipc as ipc
import pytest

from video_dqn_tpu.data import schema as jax_schema
from video_dqn_tpu.data.synthetic import make_synthetic_dataset
from video_dqn_tpu_torch.data import schema
from video_dqn_tpu_torch.data.feather import read_feather
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests import torch_qdata

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def frame(n=300, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "i64": rng.integers(-9, 9, n), "i32": rng.integers(-9, 9, n).astype(np.int32),
        "f32": rng.random(n).astype(np.float32), "f64": rng.random(n),
        "flag": rng.random(n) < 0.5,
        "path": [f"frames/vid{i % 3:03d}/{i:05d}.jpg" for i in range(n)],  # large_string
        "ep": pd.Series([f"épisode {i // 7}" for i in range(n)], dtype=object),  # string
    })
    df.loc[3, "f32"] = np.nan  # pyarrow writes pandas' NaN as a null
    df.loc[5, "f64"] = np.nan
    df.loc[4, "f64"] = np.inf
    df.loc[6, "f32"] = -np.inf
    return df


def assert_equals_pyarrow(got, path):
    table = ipc.open_file(path).read_all()
    assert list(got) == table.column_names
    for name in table.column_names:
        want = table.column(name).to_numpy(zero_copy_only=False)
        g = got[name]
        assert g.dtype == want.dtype and g.shape == want.shape, name
        if g.dtype.kind == "f":  # bit for bit, NaN included
            np.testing.assert_array_equal(g.view(np.uint8), want.view(np.uint8), err_msg=name)
        else:
            assert (g == want).all(), name


@pytest.mark.parametrize("options", [{}, {"compression": "uncompressed"}, {"chunksize": 64},
                                     {"compression": "lz4", "chunksize": 1000}],
                         ids=["lz4", "uncompressed", "batches", "lz4_one_batch"])
def test_reads_pandas_feathers_as_pyarrow_does(tmp_path, options):
    path = str(tmp_path / "t.feather")
    frame().to_feather(path, **options)
    if options.get("chunksize") == 64:
        assert ipc.open_file(path).num_record_batches == 5
    got = read_feather(path)
    assert_equals_pyarrow(got, path)
    assert got["path"].dtype == object and isinstance(got["ep"][0], str)
    assert np.isnan(got["f32"][3]) and got["f64"][4] == np.inf


def test_reads_the_jax_synthetic_dataset(tmp_path):
    path = make_synthetic_dataset(str(tmp_path), num_videos=2, frames_per_video=8,
                                  image_size=16)
    got = read_feather(path)
    assert_equals_pyarrow(got, path)
    want = jax_schema.arrays_from_frame(jax_schema.read_feather(path))
    mine = schema.arrays_from_frame(got)
    assert list(mine) == list(want)
    for k in want:
        assert mine[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(mine[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", [torch_qdata.FEATHER, torch_qdata.WIDE_FEATHER],
                         ids=["data", "wide"])
def test_reads_the_committed_fixture_feathers(name):
    path = str(ROOT / name)
    got = read_feather(path)
    assert_equals_pyarrow(got, path)
    assert got["before_image"][0].startswith(torch_qdata.FIXTURE)


def test_refuses_zstd_nulls_and_other_files(tmp_path):
    path = str(tmp_path / "z.feather")
    frame().to_feather(path, compression="zstd")
    with pytest.raises(NotImplementedError, match="ZSTD"):
        read_feather(path)
    pd.DataFrame({"n": pd.array([1, None, 3], dtype="Int64")}).to_feather(path)
    with pytest.raises(ValueError, match="'n' has 1 nulls"):
        read_feather(path)
    (tmp_path / "x.feather").write_bytes(b"PAR1 not arrow")
    with pytest.raises(ValueError, match="not an Arrow IPC"):
        read_feather(str(tmp_path / "x.feather"))


def test_schema_helpers_match_the_jax_package():
    np.testing.assert_array_equal(schema.DETECTION_THRESHOLDS, jax_schema.DETECTION_THRESHOLDS)
    assert schema.DETECTION_THRESHOLDS.dtype == jax_schema.DETECTION_THRESHOLDS.dtype
    assert schema.CLASS_LABELS == jax_schema.CLASS_LABELS
    assert schema.WIDE_COLUMNS == jax_schema.WIDE_COLUMNS
    cols = {f"s{c}": np.arange(4.0) + c for c in range(3)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(schema.multi_get(cols, "s"),
                                      jax_schema.multi_get(pd.DataFrame(cols), "s"))
    with pytest.raises(ValueError, match="missing columns"):
        schema.validate_schema({"before_image": np.array([])})
