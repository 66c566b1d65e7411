"""Wall seconds a phase of a command that prints one "[tag] ..." line as
each piece of its work ends (chip_smoke.py does), for comparing two
checkouts' runs on one machine:

    python -m lichtfeld_studio_tpu_torch.tools.phase_seconds -- python3 chip_smoke.py

Each line's tag (the text up to the first "]" of a line that starts with
"[", else "other") is given the seconds since the line before it, or
since the command started; chip_smoke.py's own "[phases]" line counts the
same way from its import. The command's lines pass through; the last line
is one JSON object: {"rc": exit code, "s": total, "phases": {tag: s}}.
Imports nothing of the package, so it can time any checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[argv.index("--") + 1:] if "--" in argv else argv
    if not cmd:
        print("usage: phase_seconds -- <command> [arguments]", file=sys.stderr)
        return 2
    t0 = last = time.perf_counter()
    phases: dict[str, float] = {}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, bufsize=1)
    for line in proc.stdout:
        now = time.perf_counter()
        tag = line[:line.find("]") + 1] if line.startswith("[") and "]" in line else "other"
        phases[tag] = phases.get(tag, 0.0) + now - last
        last = now
        sys.stdout.write(line)
        sys.stdout.flush()
    rc = proc.wait()
    print(json.dumps({"rc": rc, "s": round(time.perf_counter() - t0, 1),
                      "phases": {k: round(v, 1) for k, v in phases.items()}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
