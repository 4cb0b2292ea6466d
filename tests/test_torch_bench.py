"""The port's bench cells on the CPU, without rendering: the cell table and
the options each cell's renderer is built with (app/bench.make_renderer,
its scene load and renderer replaced by stubs that record them)."""

import pytest

from tauray_torch.app import bench


class _Renderer:
    def set_scene(self, scene):
        self.scene = scene


@pytest.fixture
def built(monkeypatch):
    """make_renderer's parsed options per call, nothing loaded or
    rendered."""
    seen = []
    monkeypatch.setattr(bench, "load_scenes", lambda opt: object())

    def create(opt, scene, device):
        seen.append(opt)
        return _Renderer()
    monkeypatch.setattr(bench, "create_renderer", create)
    return seen


def _fields(opt):
    return {f: getattr(opt, f) for f in vars(opt) if f != "scene_paths"}


def test_raster_foliage_cell_is_raster_1080p_on_the_foliage_scene(built):
    """raster_foliage_1080p builds raster_1080p's renderer (every option
    alike) on the foliage scene."""
    assert bench.CELLS["raster_foliage_1080p"] == (
        bench.SCENE_FOLIAGE, 1920, 1080, 1, "raster", ())
    bench.make_renderer(*bench.CELLS["raster_1080p"])
    bench.make_renderer(*bench.CELLS["raster_foliage_1080p"])
    plain, foliage = built
    assert foliage.scene_paths == [bench.SCENE_FOLIAGE]
    assert plain.scene_paths == [bench.SCENE]
    assert foliage.renderer == "raster"
    assert (foliage.width, foliage.height) == (1920, 1080)
    a, b = _fields(plain), _fields(foliage)
    assert a.keys() == b.keys()
    # every field alike, NaN defaults included
    assert [k for k in a if not (a[k] == b[k] or a[k] != a[k] and
                                 b[k] != b[k])] == []


def test_bench_runs_raster_foliage_cell(monkeypatch, capsys):
    """--cells=raster_foliage_1080p passes the cell check and runs the
    cell as raster_1080p's is run (update_frame frames, the raster
    split)."""
    ran = []

    def run_cell(*cell, **kw):
        ran.append(cell)
        return {"cell": cell[0]}, None
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "card", lambda: {"name": "stub"})
    monkeypatch.setattr(bench, "run_cell", run_cell)
    assert bench.main(["--cells=raster_foliage_1080p"]) == 0
    assert ran == [bench.CELLS["raster_foliage_1080p"]]
    assert "raster" in bench.RASTER
    assert '"raster_foliage_1080p"' in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown cells"):
        bench.main(["--cells=raster_foliage_720p"])
