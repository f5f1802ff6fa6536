"""Compare the ptxas resource lines of two builds of the port's kernels.

    python3 examples/torch_ptxas_diff.py OLD.log NEW.log [PATTERN ...]

OLD.log and NEW.log are build logs (``build/torch_kernels/<library>.log``,
written by ``ops/build.py``, which compiles with ``-Xptxas -v``). For every
entry function whose mangled name contains one of the PATTERNs (every entry
without a pattern), it prints the entries whose registers, stack, spills or
shared memory differ between the two logs, and those in one log only, then
one summary line. Exit code 1 if any common entry differs.
"""

import re
import sys

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
USED = re.compile(r"Used (\d+) registers")


def entries(path):
    """{mangled name: (resource line, stack/spill line)} of one build log."""
    out, name, spill = {}, None, ""
    for line in open(path, errors="replace"):
        m = ENTRY.search(line)
        if m:
            name, spill = m.group(1), ""
        elif name and "bytes stack frame" in line:
            spill = line.strip()
        elif name and USED.search(line):
            out[name] = (line.split(":", 1)[-1].strip(), spill)
            name = None
    return out


def main(argv):
    old, new = entries(argv[1]), entries(argv[2])
    patterns = argv[3:]

    def wanted(name):
        return not patterns or any(p in name for p in patterns)

    common = sorted(k for k in old.keys() & new.keys() if wanted(k))
    changed = [k for k in common if old[k] != new[k]]
    for k in changed:
        print(f"changed {k}:\n  old {old[k]}\n  new {new[k]}")
    for k in sorted(k for k in old.keys() - new.keys() if wanted(k)):
        print(f"old only {k}")
    for k in sorted(k for k in new.keys() - old.keys() if wanted(k)):
        print(f"new only {k}")
    print(f"{len(common)} common entries, {len(changed)} changed")
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
