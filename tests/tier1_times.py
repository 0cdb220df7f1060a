"""Tier-1's time, measured with tier-1's own command.

    python tests/tier1_times.py run TREE OUT_PREFIX [TEST_FILE ...]
    python tests/tier1_times.py compare PARENT.xml CHANGE.xml

`run` runs tier-1's command (`COMMAND`: `-n 6 --dist loadfile`, a
1,470 s limit) from the root of TREE, on `tests/` or on the test files
named, writes the junit file to OUT_PREFIX.xml and the log to
OUT_PREFIX.log, and prints the wall seconds and the CPU seconds of every
process the run waited for. `compare` sums two junit files' durations:
the whole, the tests only the second has, the tests only the first has,
and the five heaviest `test_torch_*` files of each. A run's time moves
with the host's load, so compare a parent and a change run back to back
on one host, in both orders.
"""

import collections
import json
import resource
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

COMMAND = ("timeout -k 10 1470 env JAX_PLATFORMS=cpu "
           "ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest {files} -q "
           "-m 'not slow' --continue-on-collection-errors "
           "-p no:cacheprovider -p xdist -n 6 --dist loadfile "
           "--junitxml={out}.xml -p no:randomly > {out}.log 2>&1")


def run(tree: str, out: str, files=()) -> dict:
    start = time.perf_counter()
    rc = subprocess.call(COMMAND.format(files=" ".join(files) or "tests/",
                                        out=out), shell=True, cwd=tree)
    usage = resource.getrusage(resource.RUSAGE_CHILDREN)
    return {"rc": rc, "wall_s": round(time.perf_counter() - start, 1),
            "cpu_s": round(usage.ru_utime + usage.ru_stime, 1)}


def durations(path: str) -> dict:
    """Test id -> seconds, from a junit file."""
    root = ET.parse(path).getroot()
    return {f"{tc.get('classname')}::{tc.get('name')}":
            float(tc.get("time", 0)) for tc in root.iter("testcase")}


def by_file(times: dict) -> collections.Counter:
    files = collections.Counter()
    for test, seconds in times.items():
        files[test.split("::")[0].split(".")[1]] += seconds
    return files


def compare(parent: str, change: str) -> dict:
    p, c = durations(parent), durations(change)

    def heaviest(times):
        return [(name, round(s, 1)) for name, s in by_file(times).most_common()
                if name.startswith("test_torch_")][:5]

    return {"summed_s": [round(sum(p.values()), 1), round(sum(c.values()), 1)],
            "tests": [len(p), len(c)],
            "new_tests_s": round(sum(s for t, s in c.items() if t not in p), 1),
            "gone_tests_s": round(sum(s for t, s in p.items() if t not in c), 1),
            "heaviest": [heaviest(p), heaviest(c)]}


if __name__ == "__main__":
    verb, *args = sys.argv[1:]
    if verb == "run":
        print(json.dumps(run(args[0], args[1], args[2:])))
    else:
        print(json.dumps(compare(*args), indent=1))
