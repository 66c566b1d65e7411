"""tools/phase_seconds.py: each line's tag gets the seconds since the line
before it, the lines pass through, the last line is the JSON summary."""

import json
import sys

from lichtfeld_studio_tpu_torch.tools import phase_seconds


def test_phase_seconds_splits_by_tag(capsys):
    script = ("import time; print('[a] one', flush=True); time.sleep(0.2); "
              "print('[b] two', flush=True); print('plain', flush=True); print('[a] three')")
    assert phase_seconds.main(["--", sys.executable, "-c", script]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:4] == ["[a] one", "[b] two", "plain", "[a] three"]
    summary = json.loads(lines[-1])
    assert summary["rc"] == 0 and set(summary["phases"]) == {"[a]", "[b]", "other"}
    assert summary["phases"]["[b]"] >= 0.2
    assert abs(sum(summary["phases"].values()) - summary["s"]) < 0.3


def test_phase_seconds_passes_the_exit_code_on(capsys):
    assert phase_seconds.main(["--", sys.executable, "-c", "raise SystemExit(3)"]) == 3
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["rc"] == 3
