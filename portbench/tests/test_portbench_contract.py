"""BENCHMARK.json and the files it names: every cell, configuration,
traffic, driver and metric reader found by name; names, units and keys
within the benchmark's rules; a file a later change adds found by name."""

from __future__ import annotations

import json
import os
import re
import textwrap

import pytest

from portbench import harness
from portbench.common import estimator_settings
from portbench.reference import geometry, mc

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):  # a config's source is a URL
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    _, config, traffic = harness.cell_spec(BENCH, cell["name"])
    assert os.path.isfile(os.path.join(harness.PB, "drivers",
                                       traffic["driver"] + ".py"))
    assert "limits" in traffic["params"]
    assert config["name"] == cell["config"]
    e2e = [m["name"] for m in harness.metrics_of(BENCH, cell["name"],
                                                 "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in harness.metrics_of(BENCH, cell["name"], "per_layer"):
        assert m["moves"] in e2e, (m["name"], cell["name"])
    assert harness.metrics_of(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    folder = "metrics" if metric in BENCH["per_layer"] else "end_to_end"
    assert callable(harness.load_reader(folder, metric["name"]))


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] <= 0.25


def test_per_layer_entries():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in E2E
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_config_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert c["reduced"] == []
        assert len(c["source"]) <= 200


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_a_configuration_states_what_runs(conf):
    """Every key of a configuration file is read by the drivers or the
    reference, or describes; what it states is what the reference runs."""
    from cpu_based_ray_tracer_tpu_torch.config import RenderConfig

    with open(os.path.join(harness.ROOT, conf["file"])) as f:
        config = json.load(f)
    assert set(config) <= {
        "name", "about", "scene", "engine", "triangles", "mesh",
        "cluster_size", "rr_survival", "t_min", "shadow_tolerance",
        "materials", "camera", "precision", "guarantees", "assumed"}
    verts, mats, _ = geometry.config_triangles(config)
    assert len(verts) == len(mats) == config["triangles"]
    settings = estimator_settings(config)
    mc.Settings(1, 1, 1, 1, **settings)
    RenderConfig(width=1, height=1, spp=1, max_depth=1, **settings)
    if "camera" in config:
        cam = config["camera"]
        assert tuple(cam["position"]) == geometry.CAMERA_POSITION
        assert tuple(cam["forward"]) == geometry.CAMERA_FORWARD
        assert cam["vfov_degrees"] == geometry.CAMERA_VFOV
    if "materials" in config:
        m = config["materials"]
        for tag in ("white", "red", "green"):
            assert tuple(m[tag]) == geometry.ALBEDO[geometry.MAT_ID[tag]]
        assert tuple(m["light_emission"]) == \
            geometry.EMISSION[geometry.MAT_ID["light"]]


def test_a_configuration_with_another_count_is_refused():
    config = dict(json.load(open(os.path.join(
        harness.ROOT, "portbench/configs/cornell_mc.json"))), triangles=33)
    with pytest.raises(ValueError):
        geometry.config_triangles(config)


def test_a_new_reader_is_found_by_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new_metric.x.py").write_text(textwrap.dedent(
        """
        def read(run):
            return 42.0
        """))
    monkeypatch.setattr(harness, "PB", str(tmp_path))
    assert harness.load_reader("metrics", "new_metric.x")(None) == 42.0


def test_a_new_cell_is_found_by_name(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "cornell_mc.new_mix",
                               "config": "cornell_mc", "traffic": "new_mix",
                               "chips": 1, "why": "a test"})
    (tmp_path / "portbench" / "traffic").mkdir(parents=True)
    (tmp_path / "portbench" / "configs").mkdir()
    (tmp_path / "portbench" / "traffic" / "new_mix.json").write_text(
        json.dumps({"driver": "final_render", "params": {"spp": 2}}))
    for c in bench["configs"]:
        src = os.path.join(harness.ROOT, c["file"])
        with open(src) as f:
            (tmp_path / c["file"]).write_text(f.read())
    cell, config, traffic = harness.cell_spec(bench, "cornell_mc.new_mix",
                                              root=str(tmp_path))
    assert traffic["params"] == {"spp": 2} and config["name"] == "cornell_mc"
