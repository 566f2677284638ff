"""What K5, the SVGF a-trous pass, is made of on the card, and what its
time follows: for each given `svgf.cu` (this tree's, a parent's), it

- builds the library with the port's nvcc flags and counts the SASS
  instructions (`cuobjdump -sass`) of each `atrous_kernel` by class:
  global loads, stores, MUFU (the special function unit), fp32
  arithmetic, integer and address arithmetic, control; beside them the
  lengths of one `expf` and one `powf` as compiled with the same flags
  (probe kernels, less a probe that only copies);
- times one pass (`tpt_atrous`) at steps 1 and 16 on 1920x1080 planes
  with a sky patch, back to back, and, where the source has it, the
  frame's five passes in one call (`tpt_atrous_passes`); the same for
  variants of the source built in a temporary directory (VARIANTS:
  `powf(a, b)` as `a * b`, whose results differ and which is timed only;
  other strip heights and register limits), each where the source has
  the text it replaces.

A CUDA card and nvcc are needed. Run it from the repository's root:

    python scripts/svgf_sass.py tpt_torch/csrc/svgf.cu \\
        _archive_check/parent/tpt_torch/csrc/svgf.cu
"""

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tpt_torch import _build  # noqa: E402
from tpt_torch.bvh.packet_traverse import NVCC_FLAGS  # noqa: E402

H, W = 1080, 1920
SIG = (1.0, 128.0, 4.0)
REPS = 50
PROBES = r'''
__global__ void probe_copy(const float* a, float* o, float s) {
  o[threadIdx.x] = a[threadIdx.x] + s;
}
__global__ void probe_exp(const float* a, float* o, float s) {
  o[threadIdx.x] = expf(a[threadIdx.x]) + s;
}
__global__ void probe_pow(const float* a, float* o, float s) {
  o[threadIdx.x] = powf(a[threadIdx.x], s) + s;
}
'''
# variants timed beside each source, where its text has what they
# replace: (label, [(old, new), ...])
VARIANTS = {
    "powf(a, b) as a * b": [("#include <math.h>",
                             "#include <math.h>\n#define POW_STANDIN(a, b) "
                             "((a) * (b))"), ("powf(", "POW_STANDIN(")],
    "3 blocks a SM (at most 85 registers)": [
        ("#define ATROUS_BLOCKS 4", "#define ATROUS_BLOCKS 3")],
    "4 rows a strip": [("#define ATROUS_THREADS 256",
                        "#define ATROUS_THREADS 128")],
    "16 rows a strip": [("#define ATROUS_THREADS 256",
                         "#define ATROUS_THREADS 512")],
}
CLASSES = (
    ("global loads", re.compile(r"^(LDG|LD)\b")),
    ("stores", re.compile(r"^(STG|ST)\b")),
    ("MUFU", re.compile(r"^MUFU\b")),
    ("fp32", re.compile(r"^(FADD|FMUL|FFMA|FMNMX|FSETP|FSEL|FCHK|FSET|"
                        r"FRND|F2I|I2F|FSWZADD)\b")),
    ("control", re.compile(r"^(BRA|EXIT|BSSY|BSYNC|CALL|RET|WARPSYNC|BAR|"
                           r"NOP|YIELD|BMOV|JMP|BREAK)\b")),
    ("shuffles", re.compile(r"^SHFL\b")),
)


def build(src: str, out_dir: str, name: str) -> str:
    so = os.path.join(out_dir, f"lib{name}.so")
    cmd = ([_build.find_nvcc()] + NVCC_FLAGS + ["-I", os.path.dirname(src),
                                                "-o", so, src])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "atrous" in line or ("Used" in line and "registers" in line):
            print(f"    ptxas: {line.strip()}")
    return so


def sass(so: str) -> dict:
    """{function name: [opcodes]} of a library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def classify(ops: list) -> dict:
    out = collections.Counter()
    for op in ops:
        for label, rx in CLASSES:
            if rx.match(op):
                out[label] += 1
                break
        else:
            out["integer, address, other"] += 1
    out["MUFU.EX2"] = sum(op.startswith("MUFU.EX2") for op in ops)
    out["MUFU.LG2"] = sum(op.startswith("MUFU.LG2") for op in ops)
    out["total"] = len(ops)
    return dict(out)


def planes(device):
    rs = np.random.default_rng(5)
    f = lambda *s: torch.from_numpy(rs.random(s).astype(np.float32))
    depth = f(H, W) * 3 + 10
    depth[:, W // 2:] += 40.0
    depth[H // 3:H // 2, W // 4:W // 2] = -1000.0
    n = torch.from_numpy(rs.normal(size=(3, H, W)).astype(np.float32))
    n = n / n.norm(dim=0, keepdim=True)
    ps = [f(H, W) for _ in range(3)] + [f(H, W)] + [f(H, W) * 2
                                                   for _ in range(3)]
    ps += [f(H, W), depth, n[0], n[1], n[2]]
    return [p.contiguous().to(device) for p in ps]


def timed(fn) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(1e8))
    s.record()
    for _ in range(REPS):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / REPS


def arr(ps):
    return (ctypes.c_void_p * len(ps))(*[p.data_ptr() for p in ps])


def time_lib(so: str, ins, label: str) -> None:
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_atrous.argtypes = [p, p, i, i, i, f, f, f, p]
    lib.tpt_atrous.restype = ctypes.c_int
    out = [torch.empty(H, W, device="cuda") for _ in range(8)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    a_in, a_out = arr(ins), arr(out)
    for step in (1, 16):
        ms = timed(lambda: lib.tpt_atrous(a_in, a_out, H, W, step, *SIG,
                                          stream))
        print(f"    {label}: one pass at step {step}: {ms:.4f} ms")
    if hasattr(lib, "tpt_atrous_passes"):
        lib.tpt_atrous_passes.argtypes = [p, p, p, p, i, i, i, f, f, f, p]
        lib.tpt_atrous_passes.restype = ctypes.c_int
        hist = arr([torch.empty(H, W, device="cuda") for _ in range(8)])
        packed = torch.empty(5, H * W, 4, device="cuda")
        ms = timed(lambda: lib.tpt_atrous_passes(
            a_in, a_out, hist, ctypes.c_void_p(packed.data_ptr()), H, W, 5,
            *SIG, stream))
        print(f"    {label}: five passes in one call: {ms:.4f} ms "
              f"({ms / 5:.4f} a pass)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", help="svgf.cu files")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    tmp = tempfile.mkdtemp(prefix="svgf_sass_")
    probe = os.path.join(tmp, "probes.cu")
    with open(probe, "w") as f:
        f.write(PROBES)
    pf = sass(build(probe, tmp, "probes"))
    length = {k: len(v) for k, v in pf.items()}
    base = next(v for k, v in length.items() if "probe_copy" in k)
    exp_len = next(v for k, v in length.items() if "probe_exp" in k) - base
    pow_len = next(v for k, v in length.items() if "probe_pow" in k) - base
    print(f"  one expf: {exp_len} SASS instructions, one powf: {pow_len} "
          f"(probe kernels less a copy, the port's nvcc flags)")
    ins = planes("cuda")
    for k, src in enumerate(args.sources):
        print(f"== {src}")
        so = build(os.path.abspath(src), tmp, f"svgf{k}")
        for name, ops in sass(so).items():
            if "atrous" in name:
                print(f"  {name}: {classify(ops)}")
        time_lib(so, ins, "as built")
        with open(src) as f:
            text = f.read()
        for v, (label, subs) in enumerate(VARIANTS.items()):
            if any(old not in text for old, _ in subs):
                continue
            vt = text
            for old, new in subs:
                vt = vt.replace(old, new)
            variant = os.path.join(tmp, f"svgf{k}_v{v}.cu")
            with open(variant, "w") as f:
                f.write(vt)
            time_lib(build(variant, tmp, f"svgf{k}_v{v}"), ins, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
