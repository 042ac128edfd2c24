"""A whole run, with the harness's look for a card skipped (on the CPU), and
the timed path broken underneath: each fault a serving cell can have must
turn `correct` false. A serving run has no state that steps and no exchange
between chips; its faults are an answer altered where it is produced, and
half of a batch left out (its answers filled from the other half)."""

import json

import pytest
import torch

from bench_port.harness import main as harness


def _altered(served):
    run = served.fn

    def fn(frames):
        det = run(frames)
        shift = torch.zeros_like(det.boxes)
        shift[..., 0::2] = 60.0  # every frame's boxes moved 60 px to the right
        return det._replace(boxes=det.boxes + shift)

    served.fn = fn


def _half(served):
    run = served.fn

    def fn(frames):
        det = run(frames)
        h = det.boxes.shape[0] // 2
        return det._make(torch.cat([t[:h], t[:h]]) for t in det)

    served.fn = fn


@pytest.mark.parametrize("workload,fault", [("vovnet_serve_b8", _altered), ("vovnet_serve_b8", _half),
                                            ("vovnet_camera_b1", _altered)],
                         ids=["b8-altered", "b8-half", "camera-altered"])
def test_a_broken_timed_path_is_not_correct(workload, fault, capsys):
    torch.set_num_threads(4)
    rc = harness.main(["--workload", workload, "--seed", "4000000007", "--seconds", "0.05", "--trace", "0"],
                      device="cpu", break_path=fault)
    out = capsys.readouterr()
    assert rc == 0
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"] is False
    assert list(result)[-1] == "checks"
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
    assert out.err.strip().splitlines()[-1].startswith("check ")
