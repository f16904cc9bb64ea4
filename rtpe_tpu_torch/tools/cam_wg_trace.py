"""Where the time of F1's and F3's ``wgmma`` kernels goes
(``csrc/cam_wg.cuh``: ``f1_wg_kernel``, ``f3_wg_kernel``): copies of the
kernel source with parts taken out, and one with ``clock64`` marks at its
phase boundaries, built and timed on the card.

    python -m rtpe_tpu_torch.tools.cam_wg_trace [--out DIR] [--shape S]

run from the root of a checkout (beside ``chip_smoke.py``, whose seeded
``cam_case`` inputs it uses; ``--shape`` one of ``step128`` (the default,
``chip_smoke.STEP128_CAM``) or ``step256``).  Each variant is a copy of
``csrc/`` under ``--out`` (default the gitignored ``_tree/cam_wg_trace``)
with ``cam_wg.cuh`` rewritten:

* ``base``: as it is;
* ``no_weights``: the producer copies the ring's first stages only, the
  rest arrive empty (every later stage multiplies stale weights);
* ``no_mma``: no ``wgmma`` issued (their commits, waits and barriers
  stay);
* ``no_halo``: the halo's copies left out (its wait and barrier stay);
* ``no_epilogue``: F3's two epilogues (a into shared memory, the
  output) left out;
* ``floor``: ``no_weights``, ``no_mma`` and ``no_halo`` together;
* ``clock``: thread 0 of each block keeps ``clock64`` marks in registers
  and writes them at its end: the cycles of the setup (barriers and the
  BN rows), of the halo's stagings, of the branch convs without them
  (their stages and epilogues), of F1's sum of x and of the 1x1 convs.

Each is built with ``nvcc`` as ``ops/_build.py`` builds the library,
loaded, and launched through its ``cam_f1_launch`` / ``cam_f3_launch``
on the padded x and the weights ``ops/cam.py`` re-lays (the variants
change no layout).  Times are CUDA events over 10 launches after 2
(the kernel and F1's reductions, no wrapper).  Outputs other than
``base``'s are meaningless.  Prints one JSON line: ms a launch of each
variant and op, and the clock run's mean cycles a block by phase with
the SM clock's kHz.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

VARIANTS = {"base": (), "no_weights": ("TR_NOW",), "no_mma": ("TR_NOMMA",),
            "no_halo": ("TR_NOHALO",), "no_epilogue": ("TR_NOEPI",),
            "floor": ("TR_NOW", "TR_NOMMA", "TR_NOHALO"),
            "clock": ("TR_CLK",)}
PHASES = ("setup", "halo", "branches", "sum_x", "ones", "total")


def _sub(src: str, a: str, b: str) -> str:
    if a not in src:
        raise RuntimeError(f"cam_wg_trace: the source no longer holds "
                           f"{a[:60]!r}")
    return src.replace(a, b, 1)


def _wrap(src: str, pattern: str, macro: str) -> str:
    """Every statement matching ``pattern`` inside #ifndef macro."""
    out, n = re.subn(pattern, lambda m: f"{m.group(1)}{{\n#ifndef {macro}\n"
                     f"{m.group(2)}\n#endif\n}}", src)
    if not n:
        raise RuntimeError(f"cam_wg_trace: no {pattern!r} to take out")
    return out


def _between(src: str, a: str, b: str, macro: str) -> str:
    """The code from just after ``a`` to just before ``b`` inside
    #ifndef macro."""
    i = src.index(a) + len(a)
    j = src.index(b, i)
    return src[:i] + f"#ifndef {macro}\n" + src[i:j] + "#endif\n" + src[j:]


def rewrite(src: str) -> str:
    """cam_wg.cuh with the variants' switches and the clock marks."""
    s = _sub(src, "    const uint32_t bytes = 2u * kw * n;\n",
             "    const uint32_t bytes = 2u * kw * n;\n#ifdef TR_NOW\n"
             "    if (s >= FNS) { mbar_expect_tx(bar0 + 8 * slot, 0); "
             "off += static_cast<int64_t>(kw) * n; ++s; return; }\n"
             "#endif\n")
    s = _wrap(s, r"(\n *)(WgmmaSS<NT>::mma\([^;]*;)", "TR_NOMMA")
    s = _wrap(s, r"(\n *)(cp16\(d \+ \(c \* t\.hr \+ h\)[^;]*;)",
              "TR_NOHALO")
    s = _between(s, "        // the lane's two fragment rows\n",
                 "      } else {\n        float v[HB][4];", "TR_NOEPI")
    s = _between(s, "      // gate)): a column's rows and gate loaded once "
                 "for the lane's two\n      // fragment rows, only the "
                 "stores masked\n",
                 "    } else {\n      float v[H1][4];", "TR_NOEPI")
    b0 = s.index("__device__ __forceinline__ void fwd_wg_body(")
    head, body = s[:b0], s[b0:]
    end = body.index("\n}\n") + 3
    fn, rest = body[:end], body[end:]
    fn = _sub(fn, "  extern __shared__ __align__(16) unsigned char smem[];\n",
              "  extern __shared__ __align__(16) unsigned char smem[];\n"
              "#ifdef TR_CLK\n  long long tr_t[8] = {0, 0, 0, 0, 0, 0, 0, 0};"
              "\n  tr_t[0] = clock64();\n#define TR_AT(k) tr_t[k] = clock64()"
              "\n#else\n#define TR_AT(k)\n#endif\n")
    fn = _sub(fn, "  // the lane's fragment rows in the image",
              "  TR_AT(1);\n  // the lane's fragment rows in the image")
    fn = _sub(fn, "        if (P.nq > 1 || (i == 0 && sl == 0)) {",
              "#ifdef TR_CLK\n        const long long tr_h = clock64();\n"
              "#endif\n        if (P.nq > 1 || (i == 0 && sl == 0)) {")
    fn, n = re.subn(r"(          cons_halo\([^;]*;\n)",
                    r"\1#ifdef TR_CLK\n          tr_t[6] += clock64() - tr_h;"
                    r"\n#endif\n", fn, count=1)
    if not n:
        raise RuntimeError("cam_wg_trace: no cons_halo call to time")
    fn = _sub(fn, "  if (!F3) {\n    // the sum of x",
              "  TR_AT(2);\n  if (!F3) {\n    // the sum of x")
    fn = _sub(fn, "  // the 1x1 convs in chunks of FN1",
              "  TR_AT(3);\n  // the 1x1 convs in chunks of FN1")
    if not fn.endswith("  }\n}\n"):
        raise RuntimeError("cam_wg_trace: fwd_wg_body's end moved")
    fn = fn[:-2] + ("#ifdef TR_CLK\n  TR_AT(4);\n  if (threadIdx.x == 0)\n"
                    "    for (int k = 0; k < 8; ++k) tr_clk[blockIdx.x][k] = "
                    "tr_t[k];\n#endif\n}\n")
    head = _sub(head, "namespace tile {\n", "namespace tile {\n#ifdef TR_CLK\n"
                "__device__ long long tr_clk[16384][8];\n#endif\n")
    rest = _sub(rest, "}  // namespace tile\n}  // namespace cam\n",
                "}  // namespace tile\n}  // namespace cam\n#ifdef TR_CLK\n"
                "extern \"C\" int tr_clk_read(long long *dst, int n) {\n"
                "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                "      dst, cam::tile::tr_clk, n * 8 * sizeof(long long)));\n"
                "}\n#endif\n")
    return head + fn + rest


def build_all(out: str) -> dict:
    """Every variant's F1 and F3 libraries, built at once."""
    from ..ops import _build
    procs = {}
    for name, flags in VARIANTS.items():
        csrc = os.path.join(out, name)
        shutil.rmtree(csrc, ignore_errors=True)
        shutil.copytree(_build.CSRC, csrc)
        path = os.path.join(csrc, "cam_wg.cuh")
        with open(path) as f:
            src = rewrite(f.read())
        with open(path, "w") as f:
            f.write(src)
        for op in ("f1", "f3"):
            lib = os.path.join(csrc, f"libcam_{op}.so")
            cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC",
                   *[f"-D{f}" for f in flags], "-o", lib,
                   os.path.join(csrc, f"cam_{op}.cu")]
            procs[name, op] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(lib)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="_tree/cam_wg_trace")
    ap.add_argument("--shape", default="step128",
                    choices=("step128", "step256"))
    a = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from ..ops import cam
    shape = {"step128": cs.STEP128_CAM, "step256": cs.STEP256_CAM}[a.shape]
    os.makedirs(a.out, exist_ok=True)
    libs = build_all(a.out)
    dev = torch.device("cuda", 0)
    k = cs.cam_case(cam, shape, cs.SEED + 10, dev)
    x, dils = k["x"], k["dils"]
    b, h, w, c = x.shape
    geo = cam._geo(x, k["kh"], dils)
    st = torch.cuda.current_stream().cuda_stream
    f32 = dict(dtype=torch.float32, device=dev)
    res = {"shape": [*shape[:4], list(shape[4]), shape[5]], "ms": {},
           "cycles": {}}
    for (name, op), lib in sorted(libs.items()):
        p = cam.tile_plan(op, *shape)
        w0, _ = cam._tile_weights(op, k["kr"], k["kh"],
                                  k["kt"] if op == "f3" else None, p)
        xpad = F.pad(x, (0, p["kc"] - c))
        fn_ws = getattr(lib, f"cam_{op}_workspace")
        fn_ws.argtypes, fn_ws.restype = [ctypes.c_void_p], ctypes.c_longlong
        ws = torch.empty(max(int(fn_ws(ctypes.addressof(geo))), 16),
                         dtype=torch.uint8, device=dev)
        launch = getattr(lib, f"cam_{op}_launch")
        launch.argtypes = cam._SIGS[f"cam_{op}"][f"cam_{op}_launch"]
        if op == "f3":
            out = torch.empty_like(x)
            ptrs = [xpad, w0, k["bnr"], k["bnh"], k["bnt"], k["gate"], ws,
                    out]
        else:
            ptrs = [xpad, w0, ws, torch.empty((2, c), **f32),
                    torch.empty((2 * len(dils), shape[5]), **f32),
                    torch.empty((b, c), **f32)]

        def run():
            err = launch(ctypes.addressof(geo),
                         *[t.data_ptr() for t in ptrs], st)
            if err:
                raise RuntimeError(f"{name} {op}: launch error {err}")
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        e0.record()
        for _ in range(10):
            run()
        e1.record()
        torch.cuda.synchronize()
        res["ms"].setdefault(name, {})[op] = e0.elapsed_time(e1) / 10
        if name == "clock":
            n = p["n_tiles"]
            buf = (ctypes.c_longlong * (8 * n))()
            lib.tr_clk_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            if lib.tr_clk_read(ctypes.addressof(buf), n):
                raise RuntimeError("cam_wg_trace: no clock marks")
            t = torch.tensor(list(buf), dtype=torch.float64).reshape(n, 8)
            by = {"setup": t[:, 1] - t[:, 0], "halo": t[:, 6],
                  "branches": t[:, 2] - t[:, 1] - t[:, 6],
                  "sum_x": t[:, 3] - t[:, 2], "ones": t[:, 4] - t[:, 3],
                  "total": t[:, 4] - t[:, 0]}
            res["cycles"][op] = {ph: float(by[ph].mean()) for ph in PHASES}
    res["sm_clock_khz"] = torch.cuda.get_device_properties(0).clock_rate \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") \
        else None
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
