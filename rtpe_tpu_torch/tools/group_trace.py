"""Where a grouping kernel's time goes, joint by joint, on one image: a
copy of the kernel source with ``clock64`` marks at its phase boundaries,
built and run on the card.

    python -m rtpe_tpu_torch.tools.group_trace [--parent <checkout>]
        [--out DIR] [--no-topk]

run from the root of a checkout (beside ``chip_smoke.py``).  Without
``--parent`` it traces this checkout's kernels (``csrc/group_core.cuh``
under ``group_lockstep.cu`` and ``group_mega.cu``), by phase of each
joint: A, the cost build and the stable key matches with the barrier
after them; B, warp 0's assignment, then its slot decisions, then the
barrier; C, the slots' update, people rows and means, then the barrier.
With ``--parent`` it traces the one-warp kernels of that checkout (the
design before ``group_core.cuh``): the load of the joint's rows, the
tag means, the cost build, the assignment, the update and the people
rows (the lockstep kernel builds and assigns row by row: each row's two
parts are timed apart and summed).  Thread 0 of block 0 (image 0) reads
the marks (into shared memory, copied out at the end).  The marked copies and their libraries go under ``--out``
(default the gitignored ``_tree/group_trace``).  Inputs:
``chip_smoke.lockstep_input`` (B=1), the first image of
``chip_smoke.nan_scene`` and, unless ``--no-topk``, the first image of
the main path's own top-k (``cam_ab.main_path_topk``).  Prints one JSON
line: for each kernel and input, the microseconds by phase summed over
the joints, before the first joint and after the last mark, the traced
block's wall microseconds and the clock's nanoseconds per cycle.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

# The marks go to shared memory while the kernel runs (a global store
# would first load the trace pointer and stall there) and are copied out
# at its end; at most MAX_J joints.
MAX_J = 32
MARK = r'''
__device__ long long *g_trace;
__shared__ long long tr_s[8 * %d];
__device__ __forceinline__ unsigned long long g_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define TR_AT(i) { const long long t_ = clock64(); \
  if (threadIdx.x == 0) tr_s[i] = t_; }
#define TR_BEGIN if (threadIdx.x == 0) \
  for (int i_ = 0; i_ < 8 * %d; ++i_) tr_s[i_] = 0; \
  const unsigned long long g0_ = g_ns(); const long long c0_ = clock64();
#define TR_END(J) { const long long c1_ = clock64(); \
  const unsigned long long g1_ = g_ns(); \
  if (blockIdx.x == 0 && threadIdx.x == 0) { long long *e_ = g_trace; \
  for (int i_ = 0; i_ < 8 * (J); ++i_) e_[i_] = tr_s[i_]; e_ += 8 * (J); \
  e_[0] = c0_; e_[1] = c1_; e_[2] = (long long)g0_; e_[3] = (long long)g1_; } }
#define CONSUME(x) asm volatile("" :: "f"(x))
#define CONSUMEI(x) asm volatile("" :: "r"(x))
''' % (MAX_J, MAX_J)

SET_TRACE = '''
extern "C" int set_trace(long long *p) {
  return (int)cudaMemcpyToSymbol(%s, &p, sizeof(p));
}
'''

# phase: (label, later mark, earlier mark), or (label, mark) for a sum
PHASES = {
    "new": [("A_build_and_key_matches", 1, 0), ("B_assignment", 2, 1),
            ("B_slot_decisions", 3, 2), ("B_barrier", 4, 3),
            ("C_update_rows_means", 5, 4), ("C_barrier", 6, 5)],
    "parent_lockstep": [("load", 1, 0), ("means", 2, 1), ("build", 4),
                        ("assignment", 5), ("update", 6, 3),
                        ("people_rows", 7, 6)],
    "parent_mega": [("load", 1, 0), ("means", 2, 1), ("build", 3, 2),
                    ("assignment", 4, 3), ("update", 5, 4),
                    ("people_rows", 6, 5)],
}


def _sub(src: str, pairs) -> str:
    for a, b in pairs:
        if src.count(a) != 1:
            raise SystemExit(f"group_trace: the source does not have one "
                             f"{a[:60]!r}: not the design this mark is for")
        src = src.replace(a, b)
    return src


def mark_core(core: str) -> str:
    """``group_core.cuh`` with marks 0-6 a joint."""
    return _sub(core, [
        ("namespace groupcore {\n", "namespace groupcore {\n" + MARK),
        ("  bool ok = true;  // warp 0: every LAP solve found its columns\n",
         "  bool ok = true;\n  TR_BEGIN\n"),
        ("    const Rows<D> &rw = sh.rows[j & 1];\n",
         "    TR_AT(8 * j)\n    const Rows<D> &rw = sh.rows[j & 1];\n"),
        ("    __syncthreads();\n\n    // ---- B: assignment",
         "    __syncthreads();\n    TR_AT(8 * j + 1)\n\n"
         "    // ---- B: assignment"),
        ("      decide<S, D, Q>(sh, rw, act, matched, col, K, npv, lo, p_max, "
         "lane);\n    }\n    __syncthreads();\n",
         "      TR_AT(8 * j + 2)\n"
         "      decide<S, D, Q>(sh, rw, act, matched, col, K, npv, lo, p_max, "
         "lane);\n      TR_AT(8 * j + 3)\n    }\n"
         "    __syncthreads();\n    TR_AT(8 * j + 4)\n"),
        ("      sh.key[tid] = key;\n    }\n    cp_async_wait_all();\n"
         "    __syncthreads();\n  }",
         "      sh.key[tid] = key;\n    }\n    TR_AT(8 * j + 5)\n"
         "    cp_async_wait_all();\n    __syncthreads();\n"
         "    TR_AT(8 * j + 6)\n  }\n  TR_END(J)"),
    ])


def _mark_parent_common(src: str) -> list:
    return [
        ("namespace {\n", "namespace {\n" + MARK),
        ("  for (int j = 0; j < J; ++j) {\n    // this lane's",
         "  TR_BEGIN\n  for (int j = 0; j < J; ++j) {\n"
         "    const int T = 8 * j;\n    TR_AT(T)\n"
         "    // this lane's"),
    ]


def mark_parent_lockstep(src: str) -> str:
    """The one-warp lockstep kernel with marks: 0 start, 1 rows loaded,
    2 means, 3 loop 1 done, 4 / 5 its build / argmin cycles, 6 update,
    7 people rows."""
    return _sub(src, _mark_parent_common(src) + [
        ("    const int p_cur = min(npv, m);\n    const bool skip_all",
         "    CONSUME(r_val + r_x + r_y + r_tag[0]);\n    TR_AT(T + 1)\n"
         "    long long tb = 0, ta = 0;\n"
         "    const int p_cur = min(npv, m);\n    const bool skip_all"),
        ("    // ---- loop 1: greedy decisions against the frozen means\n",
         "    CONSUME(mean[0][0] + mean[0][3]);\n    TR_AT(T + 2)\n"
         "    // ---- loop 1: greedy decisions against the frozen means\n"),
        ("    for (int r = 0; r < K; ++r) {\n      const float v_r = "
         "__shfl_sync(FULL, r_val, r);\n",
         "    for (int r = 0; r < K; ++r) {\n      const long long tA = "
         "clock64();\n      const float v_r = __shfl_sync(FULL, r_val, r);\n"),
        ("#pragma unroll\n      for (int off = 16; off > 0; off >>= 1) {\n"
         "        const float ob",
         "      CONSUME(best); CONSUMEI(best_s);\n"
         "      const long long tB = clock64();\n"
         "#pragma unroll\n      for (int off = 16; off > 0; off >>= 1) {\n"
         "        const float ob"),
        ("        my_active = active;\n      }\n    }\n",
         "        my_active = active;\n      }\n"
         "      CONSUMEI((int)used[0] + (int)used[3]);\n"
         "      const long long tC = clock64();\n"
         "      tb += tB - tA; ta += tC - tB;\n    }\n    TR_AT(T + 3)\n"
         "    if (threadIdx.x == 0) { tr_s[T + 4] = tb; tr_s[T + 5] = ta; }\n"),
        ("      if (alloc) npv = min(npv + 1, p_max);\n    }\n\n"
         "    // ---- people rows",
         "      if (alloc) npv = min(npv + 1, p_max);\n    }\n"
         "    CONSUMEI(npv); CONSUME(tsum[0][0] + keys[0]);\n    TR_AT(T + 6)\n"
         "\n    // ---- people rows"),
        ("    }\n  }\n  if (lane == 0) n_people[b] = npv;",
         "    }\n    TR_AT(T + 7)\n  }\n  TR_END(J)\n"
         "  if (lane == 0) n_people[b] = npv;"),
    ])


def mark_parent_mega(src: str) -> str:
    """The one-warp mega-kernel with marks: 0 start, 1 rows loaded,
    2 means, 3 build, 4 assignment, 5 update, 6 people rows."""
    return _sub(src, _mark_parent_common(src) + [
        ("    const bool my_valid = lane < K && r_val > det_thr;\n",
         "    const bool my_valid = lane < K && r_val > det_thr;\n"
         "    CONSUME(r_val + r_x + r_y + r_tag[0]);\n    TR_AT(T + 1)\n"),
        ("    // ---- cost build\n",
         "    CONSUME(mean[0][0] + mean[0][3]);\n    TR_AT(T + 2)\n"
         "    // ---- cost build\n"),
        ("    __syncwarp();\n\n    // ---- assignment\n",
         "    __syncwarp();\n    TR_AT(T + 3)\n\n    // ---- assignment\n"),
        ("    __syncwarp();\n\n    // ---- update, row by row",
         "    __syncwarp();\n    TR_AT(T + 4)\n\n    // ---- update, row by row"),
        ("    __syncwarp();  // the next joint's build overwrites the shared "
         "arrays\n",
         "    __syncwarp();  // the next joint's build overwrites the shared "
         "arrays\n    CONSUMEI(npv); CONSUME(tsum[0][0] + keys[0]);\n"
         "    TR_AT(T + 5)\n"),
        ("    }\n  }\n  // a solve that found",
         "    }\n    TR_AT(T + 6)\n  }\n  TR_END(J)\n  // a solve that found"),
    ])


def build(out: str, csrc: str, stem: str, source: str) -> ctypes.CDLL:
    from rtpe_tpu_torch.ops import _build
    path = os.path.join(out, f"{stem}.cu")
    with open(path, "w") as f:
        f.write(source)
    lib = os.path.join(out, f"lib{stem}.so")
    res = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17",
                          "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", out,
                          "-I", csrc, "-o", lib, path],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {stem}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(lib)


def trace(lib, solver: str, tag, loc, val, m: int = 30,
          p_max: int = 90) -> tuple:
    """Marks (J, 8) of image 0 and the ns per cycle, after two warm-ups."""
    import torch
    b, j, k, d = tag.shape
    if j > MAX_J:
        raise SystemExit(f"group_trace: at most {MAX_J} joints")
    people = torch.empty((b, p_max, j, 3 + d), device=tag.device)
    n = torch.empty(b, dtype=torch.int32, device=tag.device)
    marks = torch.zeros(8 * j + 4, dtype=torch.int64, device=tag.device)
    if lib.set_trace(ctypes.c_void_p(marks.data_ptr())) != 0:
        raise SystemExit("group_trace: cudaMemcpyToSymbol failed")
    args = [ctypes.c_void_p(t.data_ptr()) for t in (tag, loc, val)]
    args += [ctypes.c_int(x) for x in (b, j, k, d, m, p_max)]
    args += [ctypes.c_float(0.1), ctypes.c_float(1.0), ctypes.c_int(1),
             ctypes.c_int(0)]
    if solver == "lockstep":
        launch = lib.group_lockstep_launch
    else:
        launch = lib.group_mega_launch
        args.append(ctypes.c_int(int(solver == "greedy")))
    args += [ctypes.c_void_p(people.data_ptr()),
             ctypes.c_void_p(n.data_ptr()),
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]
    for _ in range(3):
        if launch(*args) != 0:
            raise SystemExit(f"group_trace: {solver} launch failed")
        torch.cuda.synchronize()
    t = marks.cpu().tolist()
    c0, c1, g0, g1 = t[8 * j:]
    return [t[8 * i:8 * i + 8] for i in range(j)], (c0, c1), \
        (g1 - g0) / (c1 - c0)


def by_phase(marks, ends, ns_per_cycle: float, phases) -> dict:
    """Microseconds by phase summed over the joints, each joint's span,
    and outside the joints' marks: between them, before the first (the
    first joint's rows, the set-up) and after the last."""
    us = lambda cycles: round(cycles * ns_per_cycle / 1e3, 3)   # noqa: E731
    out = {}
    for label, *ix in phases:
        out[label] = us(sum(row[ix[0]] - (row[ix[1]] if len(ix) > 1 else 0)
                            for row in marks))
    out["joints"] = [us(max(row) - row[0]) for row in marks]
    out["between_the_joints"] = us(sum(b[0] - max(a) for a, b in
                                       zip(marks, marks[1:])))
    out["before_the_joints"] = us(marks[0][0] - ends[0])
    out["after_the_last_mark"] = us(ends[1] - max(marks[-1]))
    out["wall"] = us(ends[1] - ends[0])
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--out", default="_tree/group_trace")
    ap.add_argument("--no-topk", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    root = os.path.abspath(a.parent or ".")
    csrc = os.path.join(root, "rtpe_tpu_torch", "csrc")
    out = os.path.abspath(os.path.join(a.out, "parent" if a.parent
                                       else "new"))
    os.makedirs(out, exist_ok=True)

    def read(name):
        with open(os.path.join(csrc, name)) as f:
            return f.read()

    if a.parent:
        libs = {"lockstep": (build(out, csrc, "lockstep_marked",
                                   mark_parent_lockstep(
                                       read("group_lockstep.cu"))
                                   + SET_TRACE % "g_trace"),
                             "parent_lockstep")}
        mega = build(out, csrc, "mega_marked",
                     mark_parent_mega(read("group_mega.cu"))
                     + SET_TRACE % "g_trace")
    else:
        with open(os.path.join(out, "group_core.cuh"), "w") as f:
            f.write(mark_core(read("group_core.cuh")))
        libs = {"lockstep": (build(out, csrc, "lockstep_marked",
                                   read("group_lockstep.cu")
                                   + SET_TRACE % "groupcore::g_trace"),
                             "new")}
        mega = build(out, csrc, "mega_marked", read("group_mega.cu")
                     + SET_TRACE % "groupcore::g_trace")
    phases = "new" if not a.parent else "parent_mega"
    libs["greedy"] = (mega, phases)
    libs["lap"] = (mega, phases)

    inputs = {"lockstep_input": cs.lockstep_input(
        1, np.random.default_rng(cs.SEED + 1), dev)}
    nan = cs.nan_scene(np.random.default_rng(cs.SEED + 6))
    inputs["nan"] = tuple(torch.from_numpy(x[:1]).to(dev) for x in nan)
    if not a.no_topk:
        from rtpe_tpu_torch.tools.cam_ab import main_path_topk
        val, loc, tag = main_path_topk(dev)
        inputs["topk"] = (tag[:1], loc[:1], val[:1])
    report = {"card": torch.cuda.get_device_name(0),
              "tree": "parent" if a.parent else "new"}
    for solver, (lib, phases) in libs.items():
        for name, (tag, loc, val) in inputs.items():
            marks, ends, nspc = trace(lib, solver, tag, loc, val)
            report[f"{solver} {name}"] = {
                "us": by_phase(marks, ends, nspc, PHASES[phases]),
                "ns_per_cycle": round(nspc, 4)}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
