"""The port's offline ETL (floodgan_tpu_torch/pre_processing) against the JAX
package's on the same seeded inputs: the stack functions bit for bit on
every branch, the metadata CSVs byte for byte against pandas' output, the
script emitters' text, the split summary, and the split CSV read back by
the port's dataset resolver.
"""

import struct
import sys

import numpy as np
import pandas as pd
import pytest

import floodgan_tpu.pre_processing as jax_pp
from floodgan_tpu.pre_processing import explore as jax_explore
from floodgan_tpu.pre_processing import metadata as jax_metadata
from floodgan_tpu.pre_processing import scripts as jax_scripts
from floodgan_tpu.pre_processing import stack as jax_stack
import floodgan_tpu_torch.pre_processing as pp
from floodgan_tpu_torch.data import splits, tiff
from floodgan_tpu_torch.pre_processing import explore, metadata, scripts, stack

H = W = 24


def write_geotiff(path: str, array: np.ndarray, x_min: float, y_max: float, px_w: float, px_h: float) -> None:
    """``array`` as a TIFF (the port's writer) with the two GeoTIFF tags
    that ``tiff.geotransform`` reads appended: ModelPixelScale (33550,
    (px_w, px_h, 0)) and ModelTiepoint (33922, raster (0, 0, 0) at model
    (x_min, y_max, 0)), both doubles.  A new first IFD holds the old
    entries and the two tags, after the file's bytes."""
    tiff.imwrite(path, array)
    with open(path, "r+b") as f:
        data = f.read()
        (ifd,) = struct.unpack_from("<I", data, 4)
        (n,) = struct.unpack_from("<H", data, ifd)
        entries = data[ifd + 2:ifd + 2 + 12 * n]
        start = len(data) + len(data) % 2
        scale = struct.pack("<3d", px_w, px_h, 0.0)
        tie = struct.pack("<6d", 0.0, 0.0, 0.0, x_min, y_max, 0.0)
        entries += struct.pack("<HHII", 33550, 12, 3, start) + struct.pack("<HHII", 33922, 12, 6, start + 24)
        f.write(b"\0" * (start - len(data)) + scale + tie + struct.pack("<H", n + 2) + entries + b"\0\0\0\0")
        f.seek(4)
        f.write(struct.pack("<I", start + 72))


# ------------------------------------------------------------------ stack

def test_channel_contract_and_exports_match_jax():
    assert stack.CHANNELS == jax_stack.CHANNELS
    assert sorted(pp.__all__) == sorted(jax_pp.__all__)
    assert metadata._COUNTRY == jax_metadata._COUNTRY
    assert scripts.OPENTOPO_DATASETS == jax_scripts.OPENTOPO_DATASETS


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("resolution", ["30m", "10m", "01m"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int16"])
def test_render_dem_bit_for_bit(rng, resolution, dtype):
    dem = (rng.normal(2.0, 30.0, (H, W))).astype(dtype)  # negatives for the 01m clamp
    _same(stack.render_dem(dem, resolution), jax_stack.render_dem(dem, resolution))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_river_and_flow_renders_bit_for_bit(rng, dtype):
    raster = (rng.random((H, W)) * 255).astype(dtype)
    _same(stack.render_river_distance(raster), jax_stack.render_river_distance(raster))
    _same(stack.render_flow_accumulation(raster), jax_stack.render_flow_accumulation(raster))


def _rasters(rng, rgb_kind, dem_ndim):
    def image(c):
        if rgb_kind == "uint8":
            return (rng.random((H, W, c)) * 255).astype(np.uint8)
        return rng.random((H, W, c)).astype(np.float32)  # already in [0, 1]: no /255

    dem = rng.normal(0.5, 0.2, (H, W) if dem_ndim == 2 else (H, W, 3)).astype(np.float32)
    return (image(3), dem, rng.random((H, W)).astype(np.float32),
            (rng.random((H, W)) * 255).astype(np.uint8), image(4))


@pytest.mark.parametrize("rgb_kind", ["uint8", "float"])
@pytest.mark.parametrize("dem_ndim", [2, 3])
def test_create_input_stack_bit_for_bit(rng, rgb_kind, dem_ndim):
    args = _rasters(rng, rgb_kind, dem_ndim)
    got = stack.create_input_stack(*args)
    _same(got, jax_stack.create_input_stack(*args))
    assert got.shape == (H, W, 9)


@pytest.mark.parametrize("bad", ["dem", "flow", "river"])
def test_create_input_stack_shape_error_matches(rng, bad):
    args = list(_rasters(rng, "uint8", 2))
    i = {"dem": 1, "flow": 2, "river": 3}[bad]
    args[i] = args[i][:-1]
    with pytest.raises(ValueError) as want:
        jax_stack.create_input_stack(*args)
    with pytest.raises(ValueError) as got:
        stack.create_input_stack(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kind", ["uint8_rgb", "uint8_rgba", "float_rgb"])
def test_create_output_bit_for_bit(rng, kind):
    c = 4 if kind == "uint8_rgba" else 3
    post = rng.random((H, W, c))
    post = (post * 255).astype(np.uint8) if kind.startswith("uint8") else post.astype(np.float32)
    _same(stack.create_output(post), jax_stack.create_output(post))


@pytest.mark.parametrize("mask_ndim", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_apply_masks_bit_for_bit(rng, mask_ndim, dtype):
    image = (rng.random((H, W, 9)) * 200).astype(dtype)
    mask = (rng.random((H, W) if mask_ndim == 2 else (H, W, 1)) > 0.4).astype(np.uint8)
    _same(stack.apply_masks(image, mask), jax_stack.apply_masks(image, mask))


def test_write_dataset_pair_byte_for_byte(rng, tmp_path):
    x = stack.create_input_stack(*_rasters(rng, "uint8", 3))
    y = stack.create_output((rng.random((H, W, 3)) * 255).astype(np.uint8))
    stack.write_dataset_pair(str(tmp_path / "port"), "hurricane-harvey_00000001", "01m", x, y)
    jax_stack.write_dataset_pair(str(tmp_path / "jax"), "hurricane-harvey_00000001", "01m", x, y)
    for rel in ("dataset_input/hurricane-harvey_00000001_01m.tif", "dataset_output/hurricane-harvey_00000001.tif"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    np.testing.assert_array_equal(tiff.imread(str(tmp_path / "port" / "dataset_input" /
                                                  "hurricane-harvey_00000001_01m.tif")), x)


# --------------------------------------------------------------- metadata

def _images(n_a=20, n_b=10):
    return ([f"hurricane-florence_{i:08d}" for i in range(n_a)]
            + [f"nepal-flooding_{i:08d}" for i in range(n_b)])


def test_geotiff_writer_is_read_by_both_packages(tmp_path, rng):
    from floodgan_tpu.data import tiff as jax_tiff

    p = str(tmp_path / "geo.tif")
    img = (rng.random((16, 12, 3)) * 255).astype(np.uint8)
    write_geotiff(p, img, -95.43, 29.81, 4.5e-6, 4.4e-6)
    for codec in (tiff, jax_tiff):
        assert codec.geotransform(p) == (-95.43, 29.81, 4.5e-6, 4.4e-6)
        np.testing.assert_array_equal(codec.imread(p), img)


def test_create_metadata_csv_byte_for_byte(tmp_path, rng):
    images = tmp_path / "images"
    images.mkdir()
    for i, name in enumerate(_images(6, 3)):
        h, w = 16 + i, 12 + 2 * i
        x, y = rng.uniform(-100, 90), rng.uniform(20, 40)
        write_geotiff(str(images / f"{name}.tif"), (rng.random((h, w, 3)) * 255).astype(np.uint8),
                      x, y, rng.uniform(1e-6, 1e-5), rng.uniform(1e-6, 1e-5))
    (images / "notes.txt").write_text("not an image")
    want = jax_metadata.create_metadata(str(images), str(tmp_path / "jax.csv"))
    got = metadata.create_metadata(str(images), str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert got == want.to_dict("records")
    extra = metadata.create_metadata(str(images), str(tmp_path / "port2.csv"), extend_degrees=0.01)
    jax_metadata.create_metadata(str(images), str(tmp_path / "jax2.csv"), extend_degrees=0.01)
    assert (tmp_path / "port2.csv").read_bytes() == (tmp_path / "jax2.csv").read_bytes()
    assert extra[0]["x_max_extended"] == extra[0]["x_max"] + 0.01


def test_create_metadata_of_an_empty_directory(tmp_path):
    (tmp_path / "none").mkdir()
    jax_metadata.create_metadata(str(tmp_path / "none"), str(tmp_path / "jax.csv"))
    assert metadata.create_metadata(str(tmp_path / "none"), str(tmp_path / "port.csv")) == []
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("with_dems", [False, True])
@pytest.mark.parametrize("seed", [47, 3])
def test_dataset_split_csv_byte_for_byte(tmp_path, with_dems, seed):
    images = _images()[::-1]  # not in disaster order: the split groups them
    dems = None
    if with_dems:
        res = ["01m", "10m", "30m"]
        table = {img: (res[i % 3], res[(i + 1) % 3]) for i, img in enumerate(images) if i % 4}
        dems = table
        jax_dems = pd.DataFrame.from_dict(table, orient="index", columns=["best_DEM", "same_DEM"])
    want = jax_metadata.create_dataset_split_metadata(
        images, jax_dems if with_dems else None, str(tmp_path / "jax.csv"), seed)
    got = metadata.create_dataset_split_metadata(images, dems, str(tmp_path / "port.csv"), seed)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert got == want.to_dict("records")
    originals = [r for r in got if r["version"] == "original"]
    assert sum(r["split"] == "train" for r in originals if r["disaster"] == "hurricane-florence") == 16
    assert metadata.create_dataset_split_metadata(images, dems, None, seed) == got


@pytest.mark.parametrize("n", [1, 7, 20, 33])
def test_masks_csv_byte_for_byte(tmp_path, n):
    images = [f"original_nepal-flooding_{i:08d}_0.tif" if i % 3 == 0 else
              f"generate_PairedAttention_hurricane-harvey_{i:08d}_0.tif" for i in range(n)]
    want = jax_metadata.create_masks_metadata(images, str(tmp_path / "jax.csv"))
    got = metadata.create_masks_metadata(images, str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert got == want.to_dict("records")


def test_port_split_csv_resolves_the_same_samples(tmp_path):
    for pkg, fn in (("jax", jax_metadata.create_dataset_split_metadata),
                    ("port", metadata.create_dataset_split_metadata)):
        (tmp_path / pkg).mkdir()
        fn(_images(), None, str(tmp_path / pkg / "dataset_split.csv"))
    for subset in ("usa", "india", "hurricane-florence", "all"):
        for dem in ("best", "same"):
            for crop in (None, 4):
                want = splits.determine_flood_dataset(subset, dem, crop, str(tmp_path / "jax"))
                got = splits.determine_flood_dataset(subset, dem, crop, str(tmp_path / "port"))
                assert got == want
    assert len(got["train"]) == 4 * 2 * 24  # (16 + 8) trains, each flipped too, 4 crops


# ---------------------------------------------------------------- scripts

EXTENTS = {"hurricane-harvey_00000001": (-95.5, 29.5, -95.4, 29.6),
           "nepal-flooding_00000002": (84.123456789, 27.1, 84.2, 27.25)}


@pytest.mark.parametrize("emit,args", [
    ("emit_dem_projection_script", (["dems/a.tif", "b.tif"], "out")),
    ("emit_osm_extract_script", (EXTENTS, "usa.pbf", "pbf")),
    ("emit_maperitive_script", (list(EXTENTS), "pbf", "png")),
    ("emit_georeference_script", (EXTENTS, "png", "geo")),
    ("emit_rasterize_river_script", (EXTENTS, "river.gpkg", "river")),
    ("emit_flow_crop_script", (EXTENTS, {"usa": "flow_usa.tif", "np": "flow_np.tif"},
                               {"hurricane-harvey_00000001": "usa", "nepal-flooding_00000002": "np"}, "flow")),
])
@pytest.mark.parametrize("size", [None, 2048])
def test_script_emitters_write_jax_text(tmp_path, emit, args, size):
    kw = {} if size is None or emit in ("emit_dem_projection_script", "emit_osm_extract_script") else (
        {"height": size} if emit == "emit_maperitive_script" else {"size": size})
    out = {}
    for pkg, mod in (("jax", jax_scripts), ("port", scripts)):
        path = str(tmp_path / pkg / "s.sh")
        assert getattr(mod, emit)(*args, script_path=path, **kw) == path
        out[pkg] = open(path).read()
    assert out["port"] == out["jax"] and out["port"].endswith("\n")


@pytest.mark.parametrize("dataset", ["01m", "10m", "30m", "SRTMGL1"])
def test_dem_download_url_matches_jax(dataset):
    args = (dataset, -95.5, 29.5, -95.4, 29.6, "KEY")
    assert scripts.dem_download_url(*args) == jax_scripts.dem_download_url(*args)


# ---------------------------------------------------------------- explore

def test_summarize_dataset_split_counts_match_pandas(tmp_path, capsys):
    path = str(tmp_path / "dataset_split.csv")
    metadata.create_dataset_split_metadata(_images(13, 9), None, path)
    want = jax_explore.summarize_dataset_split(path)
    capsys.readouterr()
    got = explore.summarize_dataset_split(path)
    printed = capsys.readouterr().out.splitlines()
    assert got == want.to_dict("records")
    assert printed[0].split() == ["disaster", "split", "version", "images"] and len(printed) == len(got) + 1
    assert printed[1].split() == [str(v) for v in got[0].values()]


def test_plot_extents_map_without_plotly(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "plotly", None)
    monkeypatch.setitem(sys.modules, "plotly.express", None)
    with pytest.raises(ImportError) as want:
        jax_explore.plot_extents_map(str(tmp_path / "m.csv"))
    with pytest.raises(ImportError) as got:
        explore.plot_extents_map(str(tmp_path / "m.csv"))
    assert str(got.value) == str(want.value) == "plot_extents_map requires plotly (pip install plotly)"
