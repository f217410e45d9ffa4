"""The rest of a run, past the look for a card, with the timed path broken
underneath: ``correct`` must come out false for each fault the cell can
have (a train step that returns its state unchanged; an image altered
where it is produced; half of a frame's tiles left out)."""
import json

import pytest

import control
import run
import tiny

CASES = [("train_s20k", "train_steady", "frozen"), ("train_s20k", "train_steady", "altered"),
         ("animate_s20k", "animate_motion", "altered"), ("animate_s20k", "animate_motion", "half")]


@pytest.mark.parametrize("cell,mix,fault", CASES, ids=lambda x: x)
def test_fault_is_not_correct(cell, mix, fault, capsys):
    driver = tiny.traffic(mix)["driver"]
    with control.planted(fault, driver):
        rc = run.main(tiny.args(cell, 3_000_000_101, 0), device="cpu", cfg=tiny.config(),
                      traffic=tiny.traffic(mix))
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
