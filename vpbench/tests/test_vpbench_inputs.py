"""The benchmark's frozen scene generator draws the port's scenes, a seed
gives one pool, and the device rasterizer draws the lines the port's
Pillow-exact renderer draws, to within a pixel."""

import numpy as np
import torch
import torch.nn.functional as F

from vanishing_points_2017_tpu_torch import bench
from vanishing_points_2017_tpu_torch.data.datasets import render_scene_image_wh
from vanishing_points_2017_tpu_torch.models import synth
from vanishing_points_2017_tpu_torch.pipeline import pad_lines
from vpbench import run, scenes

TRAFFIC = {"inputs": "images", "batch": 32, "pool": 1, "judged": 1,
           "lines_per_vp": [30, 60], "outliers": [10, 30],
           "noise_sigma": 3.0, "n_pad": 512}


def test_scenes_are_the_ports_scenes():
    seed = 2 ** 31 + 11
    got = scenes.draw_scenes(TRAFFIC, 32, seed)
    rng = np.random.default_rng(seed)
    want = []
    for _ in range(32):
        scene = synth.make_scene(rng, lines_per_vp=int(rng.integers(30, 60)),
                                 outliers=int(rng.integers(10, 30)))
        want.append(pad_lines(scene.segments, 512))
    for g, w in zip(got, (np.stack(z) for z in zip(*want))):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_seed0_first_scene_is_make_inputs():
    got = scenes.draw_scenes(TRAFFIC, 1, 0)
    _, *want = bench.make_inputs(1, 640, 512)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_lines_traffic_draws_the_same_scenes():
    small = dict(TRAFFIC, batch=3, pool=2)
    img = scenes.draw_pool(small, 96, 80, 2 ** 31 + 7)
    lines = scenes.draw_pool(dict(small, inputs="lines"), 96, 80, 2 ** 31 + 7)
    assert lines.images is None and img.images.shape == (2, 3, 80, 96)
    for a, b in ((img.l, lines.l), (img.lp, lines.lp),
                 (img.lmask, lines.lmask)):
        assert torch.equal(a, b)


def test_a_seed_gives_the_same_pool():
    small = dict(TRAFFIC, batch=2, pool=2)
    a = scenes.draw_pool(small, 64, 64, 1)
    b = scenes.draw_pool(small, 64, 64, 1)
    c = scenes.draw_pool(small, 64, 64, 2)
    assert torch.equal(a.images, b.images) and torch.equal(a.lp, b.lp)
    assert a.images.shape == c.images.shape
    assert not torch.equal(a.lp, c.lp) and not torch.equal(a.images, c.images)


def test_rasterized_lines_are_pillows_lines():
    rng = np.random.default_rng(5)
    for width, height in ((640, 640), (1920, 1080), (150, 110)):
        scene = synth.make_scene(rng, lines_per_vp=45, outliers=20)
        _, lp, m = pad_lines(scene.segments, 512)
        ours = scenes.rasterize(torch.from_numpy(lp)[None],
                                torch.from_numpy(m)[None], height, width)[0]
        pil = torch.from_numpy(render_scene_image_wh(scene, width, height))
        a, b = ours == scenes.INK, pil < 128
        assert set(ours.unique().tolist()) == {scenes.INK, scenes.PAPER}
        # every pixel either inks lies within 3 px of the other's ink,
        # and the two ink about as many pixels
        for x, y in ((a, b), (b, a)):
            near = F.max_pool2d(y[None].float(), 7, 1, 3)[0] > 0
            assert bool(near[x].all())
        assert 0.9 < int(a.sum()) / int(b.sum()) < 1.3


def test_cells_draw_their_pool_from_the_seed():
    import json
    import os

    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench_json = json.load(f)
    for wl in bench_json["workloads"]:
        _, _, _, traffic = run.load_cell(wl["name"])
        assert "scene_seed" not in traffic
        order, judged = run.window_order(traffic, 2 ** 31 + 1)
        assert sorted(order) == list(range(traffic["pool"]))
        assert len(judged) == traffic["judged"] <= traffic["pool"]
        assert run.window_order(traffic, 2 ** 31 + 1) == (order, judged)
        assert run.window_order(traffic, 2 ** 31 + 2)[0] != order
