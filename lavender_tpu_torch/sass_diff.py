"""Compare the SASS of two builds of the kernel library, function by
function: which kernels compiled to the same instructions.

    python -m lavender_tpu_torch.sass_diff OLD.so NEW.so [NAME ...]
        [--sub PATTERN=REPLACEMENT ...]

Runs ``cuobjdump -sass`` on both (the CUDA toolkit's, beside ``nvcc``),
splits the listings into functions, drops the address comments and
the column padding (whose width follows the library's size), and
prints per function "same", "differs" or in which build alone it is, then
the counts.  Functions are matched by mangled name with the per-build
hash of each anonymous namespace taken out (it follows the source's
path, though a source's edit can change the hash that follows its name).
``--sub`` rewrites both builds' names by a regular expression first, for
a template that gained a parameter (the tensor-core forward's KEEP:
``--sub 'Lb0E(EEvN3lvt5TcFwdE)=\1'`` matches its KEEP = false instances
to the old ones) or such a hash (``--sub 'layernorm_cu_[0-9a-f]{8}=L'``).
NAME filters the functions by substring.
Exits 0; the verdicts are the output.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

from lavender_tpu_torch.ops._build import find_nvcc

_FUNC = re.compile(r"^\s*Function : (\S+)")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def functions(so: str) -> dict:
    """{mangled name: [instruction lines]} of a library's SASS."""
    tool = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            name = _ANON.sub("_GLOBAL__N__", m.group(1))
            out[name] = []
        elif name is not None and line.strip().startswith("/*"):
            out[name].append(" ".join(_ADDR.sub("", line).split()))
    return out


def main(argv) -> int:
    old, new = functions(argv[1]), functions(argv[2])
    keep, subs, rest = [], [], iter(argv[3:])
    for a in rest:
        if a == "--sub":
            pattern, repl = next(rest).split("=", 1)
            subs.append((re.compile(pattern), repl))
        else:
            keep.append(a)
    for pattern, repl in subs:
        old = {pattern.sub(repl, k): v for k, v in old.items()}
        new = {pattern.sub(repl, k): v for k, v in new.items()}
    counts = {"same": 0, "differs": 0, "old only": 0, "new only": 0}
    for name in sorted(set(old) | set(new)):
        if keep and not any(k in name for k in keep):
            continue
        if name not in new:
            verdict = "old only"
        elif name not in old:
            verdict = "new only"
        else:
            verdict = "same" if old[name] == new[name] else "differs"
        counts[verdict] += 1
        print(f"{verdict:8} {name}")
    print(", ".join(f"{k} {v}" for k, v in counts.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
