"""A configuration, a cell and a metric added as new files, with new
manifest entries, are found without editing any file already there."""
import hashlib
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from rtbench import harness  # noqa: E402
from rtbench.tests.tiny import manifest, tiny_root  # noqa: E402


def digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_without_edits(tmp_path):
    root = tiny_root(tmp_path)
    before = digests(root)
    cfg = json.load(open(os.path.join(root, "configs", "soup234.json")))
    cfg.update(name="soup512")
    cfg["scene"].update(num_triangles=512, seed=3)
    json.dump(cfg, open(os.path.join(root, "configs", "soup512.json"), "w"))
    wl = json.load(open(os.path.join(root, "workloads",
                                     "boxcity131k.fwd.nrx4.json")))
    wl.update(name="soup512.fwd.nrx2", config="soup512", traffic="fwd.nrx2")
    wl["traffic_params"]["rx"]["count"] = 2
    json.dump(wl, open(os.path.join(root, "workloads",
                                    "soup512.fwd.nrx2.json"), "w"))
    with open(os.path.join(root, "metrics", "calls_in_window.py"), "w") as fh:
        fh.write("def read(ctx):\n    return len(ctx.latencies) or None\n")
    after = digests(root)
    assert all(after[k] == v for k, v in before.items())

    man = manifest()
    man["configs"].append(dict(name="soup512", source="test",
                               file="rtbench/configs/soup512.json",
                               reduced=[], why="test"))
    man["workloads"].append(dict(name="soup512.fwd.nrx2", config="soup512",
                                 traffic="fwd.nrx2", chips=1, why="test"))
    man["end_to_end"].append(dict(name="calls_in_window", unit="calls",
                                  better="higher", bound=0.05,
                                  source="host_clock",
                                  workloads=["soup512.fwd.nrx2"]))
    res = harness.run_cell("soup512.fwd.nrx2", 9, 0.5, False, "cpu",
                           time.perf_counter(), man, root=root,
                           log=lambda *a: None)
    assert set(res["metrics"]) == {"queries_per_s", "call_ms_p95",
                                   "setup_s", "calls_in_window"}
    assert res["metrics"]["queries_per_s"]["value"] > 0
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    shutil.rmtree(root)
