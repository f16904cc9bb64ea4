"""Where the LAP solver's and the NMS + top-k kernel's time goes: copies
of their sources with ``clock64`` phase marks, built and run on the card.

    python -m rtpe_tpu_torch.tools.solver_trace [--parent <checkout>]
        [--out DIR]

run from the root of a checkout (beside ``chip_smoke.py``).  For this
checkout, and for ``<checkout>`` when given (e.g. the parent commit
unpacked with ``git archive``), it marks:

* ``csrc/lap_core.cuh``, the one-warp LAP solver, per Dijkstra step: the
  row's shared-memory load with the distance update and the lane's best
  (``row_and_best``), the warp's argmin (``argmin``: the parent's
  shuffle butterfly, or one ``__reduce_min_sync`` + ballot), the reads of
  delta, u and p at the winner (``reads_u_p``: the parent's two
  shuffles after the update, or the owner's shuffles before it), the
  potentials' update (``update``); and the augmenting walk (``walk``);
  each mark waits on the phase's result first.  Lane 0 of every solve
  adds its cycles to global counters, so the report sums over every
  image's solves: ``lap_rect.cu`` on the 17 cost matrices the main path's
  heatmaps give it (``decode_full_batch(lap="pallas")``, B=8), and
  ``group_mega.cu``'s exact solver on the main path's top-k (B=8);
* ``csrc/nms_topk.cu``: the tile pass by phase (the tile's load with its
  halo, the pool, the select, the compaction and stores; the parent: the
  load, the pool, the K argmax rounds) and the merge by phase (the value
  select, the flat-index select, the winners' collection, the rank and
  stores; the parent: the first scan, the K rounds), block means from
  thread 0's clock, the kernels' spans from the global timer, and how
  many tiles and merges ended at the zero-key split, on the main path's
  heatmaps and on ``chip_smoke.nms_input`` at B=8 and B=1.

The marked sources and their libraries go under ``--out`` (default the
gitignored ``_tree/solver_trace``).  Prints one JSON line: for each tree
and input, the microseconds by phase and the counts.
"""

import argparse
import ctypes
import json
import os
import sys

from rtpe_tpu_torch.tools.group_trace import _sub, build

# ------------------------------------------------------------- the LAP

LAP_MARK = r'''
__device__ unsigned long long *g_trace;
__device__ int g_sink;
#define TR_WAIT(x) if (__float_as_uint((float)(x)) == 0x7fc0dead) g_sink = 1;
#define TR_NOW clock64()
'''
# counters: steps, row_and_best, argmin, reads_u_p, update, walk cycles,
# walk steps, rows
LAP_KEYS = ("steps", "row_and_best", "argmin", "reads_u_p", "update",
            "walk", "walk_steps", "rows")
LAP_FLUSH = '''  if (lane == 0)
    for (int k_ = 0; k_ < 8; ++k_) atomicAdd(g_trace + k_, tr_[k_]);
'''


def mark_lap(src: str) -> str:
    """``lap_core.cuh`` (either design) with the per-step marks."""
    common = [
        ("namespace lapcore {\n", "namespace lapcore {\n" + LAP_MARK),
        ("  for (int i = 1; i <= n_rows; ++i) {\n",
         "  unsigned long long tr_[8] = {};\n"
         "  for (int i = 1; i <= n_rows; ++i) {\n    tr_[7] += 1;\n"),
        ("      if (pass > m) return false;\n#pragma unroll\n",
         "      if (pass > m) return false;\n"
         "      const long long ta_ = TR_NOW;\n#pragma unroll\n")
        if "warp_argmin(best, best_l)" in src else
        ("      if (pass > m) return false;\n      const unsigned crow",
         "      if (pass > m) return false;\n      const long long ta_ = "
         "TR_NOW;\n      const unsigned crow"),
        ("    // augmenting walk j0 -> way[j0] -> ... -> 0, moving each (row,\n",
         "    const long long tw_ = TR_NOW;\n"
         "    // augmenting walk j0 -> way[j0] -> ... -> 0, moving each (row,\n"),
        ("      j0 = j1;\n    }\n  }\n",
         "      j0 = j1;\n      tr_[6] += 1;\n    }\n    TR_WAIT(j0)\n"
         "    tr_[5] += TR_NOW - tw_;\n  }\n" + LAP_FLUSH),
    ]
    if "warp_argmin(best, best_l)" in src:      # the parent: butterfly
        marks = [
            ("      warp_argmin(best, best_l);\n"
             "      if (!(best < INF)) return false;\n",
             "      TR_WAIT(best) TR_WAIT(best_l)\n"
             "      const long long tb_ = TR_NOW;\n"
             "      warp_argmin(best, best_l);\n"
             "      if (!(best < INF)) return false;\n"
             "      const long long tc_ = TR_NOW;\n"),
            ("      // j1 is not used, so the update above left its u "
             "untouched\n",
             "      TR_WAIT(v[0]) TR_WAIT(minv[Q - 1])\n"
             "      const long long td_ = TR_NOW;\n"
             "      // j1 is not used, so the update above left its u "
             "untouched\n"),
            ("      pj0 = col_read(p, j0);\n    }\n",
             "      pj0 = col_read(p, j0);\n      TR_WAIT(uj0) TR_WAIT(pj0)\n"
             "      const long long te_ = TR_NOW;\n"
             "      tr_[0] += 1; tr_[1] += tb_ - ta_; tr_[2] += tc_ - tb_;\n"
             "      tr_[4] += td_ - tc_; tr_[3] += te_ - td_;\n    }\n"),
        ]
    else:                                       # reduce + ballot
        marks = [
            ("      // the candidate's potential and row (its column",
             "      TR_WAIT(kb) TR_WAIT(fb)\n"
             "      const long long tb_ = TR_NOW;\n"
             "      // the candidate's potential and row (its column"),
            ("      const float delta = __shfl_sync(FULL, fb, owner);\n",
             "      TR_WAIT(owner)\n      const long long tc_ = TR_NOW;\n"
             "      const float delta = __shfl_sync(FULL, fb, owner);\n"),
            ("      if (!(delta < INF)) return false;\n",
             "      if (!(delta < INF)) return false;\n"
             "      TR_WAIT(uj0) TR_WAIT(rw)\n"
             "      const long long td_ = TR_NOW;\n"),
            ("      j0 = Q * owner + (rw & 7);\n      pj0 = rw >> 3;\n    }\n",
             "      TR_WAIT(v[0]) TR_WAIT(minv[Q - 1])\n"
             "      const long long te_ = TR_NOW;\n"
             "      tr_[0] += 1; tr_[1] += tb_ - ta_; tr_[2] += tc_ - tb_;\n"
             "      tr_[3] += td_ - tc_; tr_[4] += te_ - td_;\n"
             "      j0 = Q * owner + (rw & 7);\n      pj0 = rw >> 3;\n    }\n"),
        ]
    return _sub(src, common + marks)


# ------------------------------------------------------------- the NMS

NMS_MARK = r'''
__device__ unsigned long long *g_trace;
// per kernel (0: tile, 1: merge): phase cycle sums 0-3, blocks, the
// first start and last end on the global timer; then the zero splits
__device__ __forceinline__ unsigned long long tr_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TR_BEGIN const unsigned long long g0_ = tr_ns(); \
  long long tp_[5]; tp_[0] = clock64();
#define TR_AT(i) tp_[i] = clock64();
#define TR_END(kern, n) if (threadIdx.x == 0) { \
  const unsigned long long g1_ = tr_ns(); \
  unsigned long long *e_ = g_trace + 8 * (kern); \
  for (int i_ = 0; i_ < (n); ++i_) atomicAdd(e_ + i_, \
      (unsigned long long)(tp_[i_ + 1] - tp_[i_])); \
  atomicAdd(e_ + 4, 1ull); atomicMin(e_ + 5, g0_); atomicMax(e_ + 6, g1_); }
#define TR_ZERO(kern) if (threadIdx.x == 0) atomicAdd(g_trace + 16 + (kern), 1ull);
'''
NMS_PHASES = {
    "new": (("load", "pool", "select", "compact_store"),
            ("value_select", "index_select", "collect", "rank_store")),
    "parent": (("load", "pool", "k_rounds"), ("first_scan", "k_rounds")),
}


def mark_nms(src: str) -> str:
    """``nms_topk.cu`` (either design) with phase marks in both kernels."""
    pairs = [("namespace {\n", "namespace {\n" + NMS_MARK)]
    if "value_select" in src:                    # the threshold select
        pairs += [
            ("  if (tid == 0) {\n    ss.lt = 0u;\n    ss.eq = 0u;\n  }\n"
             "  // the tile and its halo",
             "  TR_BEGIN\n  if (tid == 0) {\n    ss.lt = 0u;\n    ss.eq = 0u;\n"
             "  }\n  // the tile and its halo"),
            ("tile[idx / LW][idx % LW] = r[i];\n  }\n  __syncthreads();\n",
             "tile[idx / LW][idx % LW] = r[i];\n  }\n  __syncthreads();\n"
             "  TR_AT(1)\n"),
            ("  count_zero_split(n_lt, n_eq, ss);\n  __syncthreads();\n\n"
             "  const unsigned kk",
             "  count_zero_split(n_lt, n_eq, ss);\n  __syncthreads();\n"
             "  TR_AT(2)\n  if (ss.lt < (unsigned)min(K, TH * TW) && "
             "(unsigned)min(K, TH * TW) <= ss.lt + ss.eq) TR_ZERO(0)\n\n"
             "  const unsigned kk"),
            ("  // compaction in flat order:",
             "  if (sel.t == 0xdeadbeefu) g_trace[31] = 1;\n  TR_AT(3)\n"
             "  // compaction in flat order:"),
            ("    oi[s] = INT_MAX;\n  }\n}\n",
             "    oi[s] = INT_MAX;\n  }\n  __syncthreads();\n  TR_AT(4)\n"
             "  TR_END(0, 4)\n}\n"),
            ("  if (tid == 0) {\n    ss.lt = 0u;\n    ss.eq = 0u;\n"
             "    n_win = 0u;\n  }\n",
             "  TR_BEGIN\n  if (tid == 0) {\n    ss.lt = 0u;\n    ss.eq = 0u;\n"
             "    n_win = 0u;\n  }\n"),
            ("  const Sel sv = value_select<MNT>(each, K, ss);\n",
             "  if (ss.lt < (unsigned)K && (unsigned)K <= ss.lt + ss.eq) "
             "TR_ZERO(1)\n"
             "  const Sel sv = value_select<MNT>(each, K, ss);\n"
             "  if (sv.t == 0xdeadbeefu) g_trace[31] = 1;\n  TR_AT(1)\n"),
            ("  for (int c = tid; c < n_cand; c += MNT) {\n"
             "    const unsigned key = key_of(c);\n",
             "  if (t_idx == 0xdeadbeefu) g_trace[31] = 1;\n  TR_AT(2)\n"
             "  for (int c = tid; c < n_cand; c += MNT) {\n"
             "    const unsigned key = key_of(c);\n"),
            ("  __syncthreads();\n  // rank:",
             "  __syncthreads();\n  TR_AT(3)\n  // rank:"),
            ("    out_y[plane * K + rank] = iw / W;\n  }\n}\n",
             "    out_y[plane * K + rank] = iw / W;\n  }\n  __syncthreads();\n"
             "  TR_AT(4)\n  TR_END(1, 4)\n}\n"),
        ]
    else:                                        # the parent: K rounds
        pairs += [
            ("  const int lh = TH + 2 * half, lw = TW + 2 * half;\n\n",
             "  const int lh = TH + 2 * half, lw = TW + 2 * half;\n"
             "  TR_BEGIN\n\n"),
            ("    tile[ly][lx] = v;\n  }\n  __syncthreads();\n",
             "    tile[ly][lx] = v;\n  }\n  __syncthreads();\n  TR_AT(1)\n"),
            ("  const long long tile_id =",
             "  __syncthreads();\n  TR_AT(2)\n  const long long tile_id ="),
            ("      oi[r] = bi;\n    }\n  }\n}\n",
             "      oi[r] = bi;\n    }\n  }\n  __syncthreads();\n  TR_AT(3)\n"
             "  TR_END(0, 3)\n}\n"),
            ("  const int plane = blockIdx.x;\n  float *cv",
             "  TR_BEGIN\n  const int plane = blockIdx.x;\n  float *cv"),
            ("  for (int r = 0; r < K; ++r) {\n    float bv = mv;\n",
             "  __syncthreads();\n  TR_AT(1)\n"
             "  for (int r = 0; r < K; ++r) {\n    float bv = mv;\n"),
            ("          mpos = c;\n        }\n    }\n  }\n}\n",
             "          mpos = c;\n        }\n    }\n  }\n  __syncthreads();\n"
             "  TR_AT(2)\n  TR_END(1, 2)\n}\n"),
        ]
    return _sub(src, pairs)


SET_TRACE = '''
extern "C" int set_trace(unsigned long long *p) {
  return (int)cudaMemcpyToSymbol(%s, &p, sizeof(p));
}
'''


def read(root: str, name: str) -> str:
    with open(os.path.join(root, "rtpe_tpu_torch", "csrc", name)) as f:
        return f.read()


def trace_tree(root: str, out: str, inputs: dict) -> dict:
    import torch
    os.makedirs(out, exist_ok=True)
    csrc = os.path.join(root, "rtpe_tpu_torch", "csrc")
    with open(os.path.join(out, "lap_core.cuh"), "w") as f:
        f.write(mark_lap(read(root, "lap_core.cuh")))
    with open(os.path.join(out, "group_core.cuh"), "w") as f:
        f.write(read(root, "group_core.cuh"))
    sym = "lapcore::g_trace"
    lap = build(out, csrc, "lap_rect_marked",
                read(root, "lap_rect.cu") + SET_TRACE % sym)
    mega = build(out, csrc, "group_mega_marked",
                 read(root, "group_mega.cu") + SET_TRACE % sym)
    nms_src = read(root, "nms_topk.cu")
    design = "new" if "value_select" in nms_src else "parent"
    nms = build(out, csrc, "nms_topk_marked",
                mark_nms(nms_src) + SET_TRACE % "g_trace")
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    report = {}

    def counters(lib, n):
        buf = torch.zeros(n, dtype=torch.int64, device=dev)
        if lib.set_trace(ctypes.c_void_p(buf.data_ptr())) != 0:
            raise SystemExit("solver_trace: cudaMemcpyToSymbol failed")
        return buf

    ns_per_cycle = inputs["ns_per_cycle"]

    def lap_report(buf):
        t = dict(zip(LAP_KEYS, buf.tolist()))
        us = {k: round(t[k] * ns_per_cycle / 1e3, 3) for k in
              ("row_and_best", "argmin", "reads_u_p", "update", "walk")}
        steps = max(t["steps"], 1)
        ns_step = {k: round(t[k] * ns_per_cycle / steps, 2) for k in
                   ("row_and_best", "argmin", "reads_u_p", "update")}
        return {"us_summed_over_solves": us, "ns_per_step": ns_step,
                "steps": t["steps"], "walk_steps": t["walk_steps"],
                "rows": t["rows"]}

    # lap_rect on the main path's cost matrices, every joint
    buf = counters(lap, len(LAP_KEYS))
    for _ in range(2):                  # the second run is the one read
        buf.zero_()
        for c in inputs["lap_costs"]:
            o = torch.empty(c.shape[:2], dtype=torch.int32, device=dev)
            err = lap.lap_rect_launch(
                ctypes.c_void_p(c.data_ptr()), ctypes.c_int(c.shape[0]),
                ctypes.c_int(c.shape[1]), ctypes.c_int(c.shape[2]),
                ctypes.c_void_p(o.data_ptr()), stream)
            if err:
                raise SystemExit(f"solver_trace: lap_rect launch {err}")
        torch.cuda.synchronize()
    report["lap_rect decode_b8"] = lap_report(buf)

    # group_mega's exact solver on the main path's top-k
    val, loc, tag = inputs["topk"]
    b, j, k, d = tag.shape
    people = torch.empty((b, 90, j, 3 + d), device=dev)
    n = torch.empty(b, dtype=torch.int32, device=dev)
    buf = counters(mega, len(LAP_KEYS))
    for _ in range(2):
        buf.zero_()
        args = [ctypes.c_void_p(t.data_ptr()) for t in (tag, loc, val)]
        args += [ctypes.c_int(x) for x in (b, j, k, d, 30, 90)]
        args += [ctypes.c_float(0.1), ctypes.c_float(1.0), ctypes.c_int(1),
                 ctypes.c_int(0), ctypes.c_int(0),
                 ctypes.c_void_p(people.data_ptr()),
                 ctypes.c_void_p(n.data_ptr()), stream]
        if mega.group_mega_launch(*args) != 0:
            raise SystemExit("solver_trace: group_mega launch failed")
        torch.cuda.synchronize()
    report["group_mega_lap topk_b8"] = lap_report(buf)

    # NMS + top-k
    tile_names, merge_names = NMS_PHASES[design]
    for name, det in inputs["nms"].items():
        bb, h, w, jj = det.shape
        kk = 30
        n_cand = nms.nms_topk_tiles(h, w) * kk
        cand_v = torch.empty((bb * jj, n_cand), device=dev)
        cand_i = torch.empty((bb * jj, n_cand), dtype=torch.int32,
                             device=dev)
        outs = [torch.empty((bb, jj, kk), device=dev, dtype=dt)
                for dt in (torch.float32, torch.int32, torch.int32)]
        buf = counters(nms, 32)
        for _ in range(2):
            buf.zero_()
            buf[5].fill_(2 ** 62)
            buf[13].fill_(2 ** 62)
            sb, sy, sx, sj = det.stride()
            err = nms.nms_topk_launch(
                ctypes.c_void_p(det.data_ptr()),
                *[ctypes.c_longlong(x) for x in (sb, sy, sx, sj)],
                *[ctypes.c_int(x) for x in (bb, h, w, jj, 5, kk)],
                ctypes.c_void_p(cand_v.data_ptr()),
                ctypes.c_void_p(cand_i.data_ptr()),
                *[ctypes.c_void_p(t.data_ptr()) for t in outs], stream)
            if err:
                raise SystemExit(f"solver_trace: nms launch {err}")
            torch.cuda.synchronize()
        t = buf.tolist()
        rep = {}
        for kern, names in ((0, tile_names), (1, merge_names)):
            e = t[8 * kern:8 * kern + 8]
            blocks = max(e[4], 1)
            rep["tile" if kern == 0 else "merge"] = {
                "blocks": e[4],
                "us_per_block": {nm: round(e[i] * ns_per_cycle / blocks
                                           / 1e3, 3)
                                 for i, nm in enumerate(names)},
                "span_us": round((e[6] - e[5]) / 1e3, 3)}
        if design == "new":
            rep["tiles_ended_at_zero_split"] = t[16]
            rep["merges_ended_at_zero_split"] = t[17]
        report[f"nms_topk {name}"] = rep
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--out", default="_tree/solver_trace")
    a = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from rtpe_tpu_torch.decode.nms import top_k
    from rtpe_tpu_torch.ops import _build
    from rtpe_tpu_torch.tools.cam_ab import (main_path_heatmaps,
                                             main_path_lap_costs)
    dev = torch.device("cuda", 0)
    probe = cs.phase_step_probe(_build, dev)
    hms, tags, pred = main_path_heatmaps(dev)
    with torch.inference_mode():
        topk = tuple(t.float().contiguous() for t in top_k(hms, tags))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    inputs = {"ns_per_cycle": probe["ns_per_step"] / probe["cycles_per_step"],
              "lap_costs": [c.contiguous() for c in
                            main_path_lap_costs(hms, tags, pred)],
              "topk": topk,
              "nms": {"main_b8": hms.float(), "main_b1": hms[:1].float(),
                      "synthetic_b8": cs.nms_input(8, gen, dev),
                      "synthetic_b1": cs.nms_input(1, gen, dev)}}
    report = {"card": torch.cuda.get_device_name(0),
              "ns_per_cycle": round(inputs["ns_per_cycle"], 4)}
    trees = [("new", ".")] + ([("parent", a.parent)] if a.parent else [])
    for label, root in trees:
        res = trace_tree(os.path.abspath(root),
                         os.path.abspath(os.path.join(a.out, label)), inputs)
        for key, val in res.items():
            report[f"{label} {key}"] = val
    print(json.dumps(report))


if __name__ == "__main__":
    main()
