"""A later cell as data only: viterbinet.joint (ViterbiNet by word with no
adaptation, from seeded random weights) added to a copy of the manifest
with its traffic file and its limits, and run through the unchanged
harness at a tiny size on the CPU."""
import json
import shutil
import time

import torch

from portbench import harness
from portbench.tests import tiny

JOINT = {"driver": "by_word", "detector": "vnet", "self_supervised": False,
         "online_meta": False, "start_params": "random",
         "pool": 4, "start_blocks": [1, 6], "start_words": [15, 9], "checked_runs": 2,
         "checked_blocks": 20,
         "profile_blocks": 50,
         "why": "ViterbiNet by word with no adaptation: the block graph alone"}
EXACT = {k: {"limit": 0} for k in ("first_block_params", "first_slot_params",
                                   "start_errors_apart", "window_errors_apart",
                                   "run_counts_apart")}
REPORTS = ("blocks_per_s", "block_p95_ms", "engine_host_ms", "detect_ms", "k5_roofline",
           "mfu.byword")


def test_joint_cell_from_data_files(tmp_path, one_thread):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(harness.ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    manifest["workloads"].append({"name": "viterbinet.joint", "config": "viterbinet",
                                  "traffic": "joint", "chips": 1, "why": JOINT["why"]})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in REPORTS:
            m["workloads"].append("viterbinet.joint")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / "portbench" / "traffic" / "joint.json").write_text(json.dumps(JOINT))
    (root / "portbench" / "limits" / "viterbinet.joint.json").write_text(json.dumps(EXACT))

    cell = tiny.cell("viterbinet.joint", root)
    assert [m["name"] for m in cell.metrics(trace=False)] == ["blocks_per_s", "block_p95_ms",
                                                              "setup_s"]
    out = cell.driver().run(cell, 5, 1.0, True, torch.device("cpu"), time.time())
    assert out.correct, out.checks
    assert out.readings["pairs"] == 0 and out.e2e["blocks_per_s"] > 0
    assert cell.reader("detect_ms").read(out.layer) > 0
