"""Run ``chip_smoke.py``'s ``phase_sections`` right after ``phase_build``
in fresh processes, again and again (ROADMAP.md, C15).

    python3 tools/sections_probe.py [PROCESSES]       # on one card

Each of PROCESSES (default 10) processes builds the kernels as
``chip_smoke.py`` does (a build left in ``build/`` by the first is
reused) and runs ``phase_sections`` once, whose traced iteration the
affinity pass checks; where the pass reports, ``phase_sections`` prints
``_log_parentless``'s lines (each beginning ``C15:``) and fails.  Prints,
for each process, its exit code, its wall time and those lines, and ends
with the number of processes in which the pass reported.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUN = ("import sys; sys.path[:0] = [{root!r}, {src!r}]; "
       "import chip_smoke as cs; cs.phase_build(); cs.phase_sections()")


def main(processes: int) -> int:
    code = RUN.format(root=str(ROOT), src=str(ROOT / "src"))
    reported = 0
    for i in range(processes):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True, timeout=900)
        out = proc.stdout + proc.stderr
        lines = [line for line in out.splitlines()
                 if line.startswith("C15:") or line.startswith("   ")
                 and " us +" in line or "affinity" in line
                 and "check failed" in line]
        hit = proc.returncode != 0 and any("affinity" in line
                                           for line in lines)
        reported += hit
        print(f"process {i}: exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s, the affinity pass "
              f"{'reported' if hit else 'passed'}", flush=True)
        for line in lines:
            print(f"  {line}")
        if proc.returncode != 0 and not hit:
            print("\n".join(out.splitlines()[-20:]))
    print(f"sections probe: the affinity pass reported in {reported} of "
          f"{processes} fresh processes")
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 10))
