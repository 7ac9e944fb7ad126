"""Compare the machine code of the `wgmma` conv body's instances between two
checkouts of the port: whether an edit to the body changed what the card
runs. Each checkout's kernels are built (into its own `_build/`), then for
every kernel whose name holds `--kernel` the SASS of `cuobjdump -sass`
(instruction addresses and encodings stripped) is hashed and compared, and
so are ptxas's registers from the build log.

    python multi_modal_image_fusion_tpu_torch/sass_diff.py \\
        --parent <checkout> --change <checkout> [--kernel conv_chain_tc_kernel]
        [--out diff.txt]

Prints one JSON line: the instances, how many are identical, those that
differ and their registers (parent, change). `--out` takes a unified diff of
each instance that differs. Needs nvcc and cuobjdump (the CUDA toolkit).
"""

import argparse
import concurrent.futures
import difflib
import hashlib
import json
import os
import re
import subprocess
import sys


def build(root):
    """(library path, nvcc path) of the checkout's built kernels."""
    code = ("import sys; sys.path.insert(0, '.'); from "
            "multi_modal_image_fusion_tpu_torch.ops.cuda import build; "
            "print(build.build()); print(build.nvcc_path())")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"build failed in {root}:\n{r.stderr[-6000:]}")
    lib, nvcc = r.stdout.strip().splitlines()[-2:]
    return os.path.join(root, lib), nvcc


def sass_and_registers(lib, nvcc, kernel):
    """({function: [instruction]}, {function: registers}) of the kernels
    whose name holds `kernel`."""
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    fns, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                fns[fn] = []
        elif fn:
            t = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
            t = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", t).strip()
            if t:
                fns[fn].append(t)
    regs, cur = {}, None
    with open(os.path.splitext(lib)[0] + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and cur and kernel in cur:
                regs[cur], cur = int(m.group(1)), None
    return fns, regs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True, help="the reference checkout")
    p.add_argument("--change", required=True, help="the changed checkout")
    p.add_argument("--kernel", default="conv_chain_tc_kernel",
                   help="a substring of the kernels' mangled names")
    p.add_argument("--out", default="", help="unified diffs of the changed "
                                             "instances")
    args = p.parse_args(argv)
    roots = (args.parent, args.change)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        built = list(ex.map(build, roots))
    (pf, pr), (cf, cr) = (sass_and_registers(lib, nvcc, args.kernel)
                          for lib, nvcc in built)

    def digest(lines):
        return hashlib.sha1("\n".join(lines).encode()).hexdigest()
    differ = sorted(f for f in pf if f not in cf
                    or digest(pf[f]) != digest(cf[f]))
    print(json.dumps({
        "kernel": args.kernel, "instances": len(pf),
        "sass_identical": len(pf) - len(differ), "sass_differ": differ,
        "registers_differ": {f: [pr.get(f), cr.get(f)] for f in pf
                             if pr.get(f) != cr.get(f)}}))
    if args.out:
        with open(args.out, "w") as fh:
            for f in differ:
                fh.write(f"== {f}\n")
                fh.write("\n".join(difflib.unified_diff(
                    pf[f], cf.get(f, []), lineterm="", n=2)) + "\n")


if __name__ == "__main__":
    main()
