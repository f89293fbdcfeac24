"""transform_waste_share.compress: wall time in the program's
transform.*.forward spans whose output was thrown away (kept false: a
stage that skipped, a stage the copy-back rule undid, or the level-5
route's trial run) over all transform.*.forward time, in %."""

from gpubench import program

SPANS = {}


def read(t, phase):
    fw = [s for _, spans in program.by_call(t, phase) for s in spans
          if s["name"].startswith("transform.")
          and s["name"].endswith(".forward")]
    total = sum(s["t1"] - s["t0"] for s in fw)
    if total <= 0:
        return None
    return 100.0 * sum(s["t1"] - s["t0"] for s in fw
                       if not s.get("kept", True)) / total
