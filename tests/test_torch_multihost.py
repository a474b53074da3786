"""The port's multi-process dryrun (dcl_net_tpu_torch/tools/
dryrun_multihost.py), counterpart of tests/test_multihost.py: the tool run
as one process and as 2 OS processes that meet through a file://
rendezvous (gloo on the CPU) on the same global batch of 8 rows at the
16^3 test size must give the same per-step training losses (step 1 within
rtol 1e-5, later steps within 5e-2: Adam amplifies the float ordering of
the cross-process sums), the same eval summary and the same stage-2
losses (within rtol 1e-5)."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CMD = [sys.executable, "-m", "dcl_net_tpu_torch.tools.dryrun_multihost",
       "--device", "cpu", "--steps", "3", "--batch", "8"]


def _env():
    return dict(os.environ, OMP_NUM_THREADS="2")


def test_two_process_dryrun_matches_single_process(tmp_path):
    ref_out = tmp_path / "ref.json"
    rendezvous = "file://" + str(tmp_path / "rendezvous")
    common = ["--coordinator", rendezvous, "--num_hosts", "2"]
    logs = [open(tmp_path / f"h{i}.log", "w") for i in range(3)]
    procs = [subprocess.Popen(CMD + ["--out", str(ref_out)], env=_env(), cwd=REPO,
                              stdout=logs[2], stderr=subprocess.STDOUT)]
    h0_out = tmp_path / "h0.json"
    procs += [subprocess.Popen(CMD + common + ["--host_id", str(i)]
                               + (["--out", str(h0_out)] if i == 0 else []),
                               env=_env(), cwd=REPO, stdout=logs[i],
                               stderr=subprocess.STDOUT) for i in range(2)]
    try:
        rcs = [p.wait(timeout=240) for p in procs]
        if any(rcs):
            raise AssertionError(f"exit codes {rcs}:\n" + "\n".join(
                f"--- {name} ---\n{(tmp_path / name).read_text()[-3000:]}"
                for name in ("h0.log", "h1.log", "h2.log")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()

    ref = json.loads(ref_out.read_text())
    got = json.loads(h0_out.read_text())
    assert ref["process_count"] == 1 and got["process_count"] == 2
    assert len(got["losses"]) == len(ref["losses"]) == 3
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"][1:], ref["losses"][1:], rtol=5e-2)
    assert got["eval"] == ref["eval"]
    assert got["eval"]["n_scored"] == 16 and got["eval"]["n_overflow"] == 0
    np.testing.assert_allclose(got["stage2_losses"], ref["stage2_losses"], rtol=1e-5)
