"""The fused-CAM kernels and the BasicBlock-chain kernel of two checkouts
of this repository on the same inputs, on one card: outputs compared,
per-launch times side by side.

    python -m rtpe_tpu_torch.tools.cam_ab --parent <checkout> [--out DIR]
        [--only cam|chain]

run from the root of the checkout under test (beside ``chip_smoke.py``,
whose seeded inputs it uses). ``<checkout>`` is another tree of the
repository, e.g. the parent commit unpacked with ``git archive`` into a
gitignored directory. The inputs (``chip_smoke.cam_case``: the train
step's two CAM shapes at B=16, a ragged signed-gate case, the card
tests' shapes, and exact-sum cases) are made once and saved; then each
tree runs the six CAM ops (``cam_f1_fwd``, ``cam_f3_fwd``,
``cam_f2_fwd`` and the three backwards) on them in a process of its own
(its root first on ``sys.path``, its kernels built into its own
``rtpe_tpu_torch/_build/``), in turns parent, new, new, parent, saving
its outputs (under --out, default the gitignored ``_tree/cam_ab``),
CUDA-event times and a ``torch.profiler`` breakdown by kernel at the two
train shapes. The last line printed is one JSON object: for each op and
case, whether each output is ``torch.equal`` to the parent's (else its
largest difference of max |parent|), whether each tree repeats itself
bitwise, and each turn's times.

The chain (``blocks.basicblock_chain``) runs on ``chip_smoke.chain_inputs``:
4-block chains at the three branch shapes of a 640 x 640 forward at B=8
and B=1 (timed), and exact-sum cases (``chain_exact*``).

An output counts as bad where it differs from the parent's, except a
pixel sum (``SUMS``, whose order a redesign may change) within
``SUM_TOL`` of max |parent|, or a chain output within ``CHAIN_TOL`` of
max |parent| (a redesign may reorder its sums), on a case that is not an
exact-sum one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

OPS = {"cam_f1_fwd": ("x", "kr", "kh"),
       "cam_f3_fwd": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate"),
       "cam_f2_fwd": ("x", "kh", "kt", "bnh"),
       "cam_f1_bwd": ("x", "kr", "kh", "dsr", "dsh", "dgap"),
       "cam_f2_bwd": ("x", "kh", "kt", "bnh", "dst"),
       "cam_f3_bwd": ("x", "kr", "kh", "kt", "bnr", "bnh", "bnt", "gate",
                      "g")}
OUT_NAMES = {"cam_f1_fwd": ("s_r", "s_h", "gap"),
             "cam_f3_fwd": ("out",), "cam_f2_fwd": ("s_t",),
             "cam_f1_bwd": ("dx", "dkr", "dkh"),
             "cam_f2_bwd": ("dx", "dkh", "dkt", "dS"),
             "cam_f3_bwd": ("dx", "dkr", "dkh", "dkt", "dSr", "dSh", "dSt",
                            "dgate"),
             "basicblock_chain": ("out",)}
# pixel sums whose order a redesign may change: held to 2^-8 of max |parent|
SUMS = {"s_r", "s_h", "gap", "s_t", "dS", "dSr", "dSh", "dSt", "dgate"}
SUM_TOL = 2.0 ** -8
CHAIN_TOL = 2.0 ** -5
TIMED = ("steps", "pyramid_hi")
CHAIN_N = 4


def kernel_part(name: str) -> str:
    """The part of an op a kernel belongs to, by its name."""
    if "wgrad_kernel<5>" in name:
        return "dkh_wgrad5"
    if "wgrad_kernel<7>" in name:
        return "wgrad7"
    if "reduce_rows" in name:
        return "reductions"
    if "conv3x3_kernel" in name:
        return "chain_conv"
    if "split_epilogue" in name:
        return "chain_split_epilogue"
    if "dx_kernel" in name:
        return "dx"
    if any(k in name for k in ("f1b_", "f2b_", "f3b_")):
        return "phase0"
    if any(k in name for k in ("f1_tile", "f2_tile", "f3_tile", "f1_kernel",
                               "f2_kernel", "f3_kernel")):
        return "forward"
    return "wrapper"


def chain_cases() -> list:
    """(name, shape, n, exact, timed) of the chain's cases."""
    import chip_smoke as cs
    out = [(f"chain_b{b}_{h}x{w}x{c}", (b, h, w, c), CHAIN_N, False, True)
           for h, w, c in cs.BRANCHES for b in (8, 1)]
    out += [(f"chain_exact{k}", shape, n, True, False) for k, (shape, n) in
            enumerate([((2, 12, 20, 96), 4), ((1, 20, 20, 384), 2),
                       ((1, 40, 40, 192), 2), ((8, 80, 80, 96), 1)])]
    return out


def make_chain_inputs(path: str) -> list:
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    saved = []
    for name, shape, n, exact, timed in chain_cases():
        x, w, b = cs.chain_inputs(shape, n, cs.SEED + 11 if timed
                                  else cs.SEED + n, dev, exact=exact)
        saved.append({"name": name, "timed": timed,
                      "t": {"x": x.cpu(), "w": w.cpu(), "b": b.cpu()}})
    torch.save(saved, path)
    return [c["name"] for c in saved]


def make_inputs(path: str) -> list:
    import torch
    import chip_smoke as cs
    from rtpe_tpu_torch.ops import cam
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [("steps", cs.STEPS_CAM, False, False),
             ("pyramid_hi", cs.PYRAMID_CAM, False, False),
             ("ragged_signed", (3, 29, 21, 83, (1, 2, 3, 4), 20), False,
              True)]
    card = [(2, 21, 21, 12, (1, 2, 3), 3), (2, 17, 23, 163, (1, 2, 3), 40),
            (2, 9, 13, 83, (1, 2, 3, 4), 20), (1, 5, 30, 163, (1, 2, 3), 40),
            (1, 30, 5, 83, (1, 2, 3, 4), 20), (1, 11, 19, 12, (1, 9), 3),
            (1, 9, 10, 170, (1, 2), 8)]
    cases += [(f"card{k}", s, False, True) for k, s in enumerate(card)]
    cases += [("exact163", (2, 12, 20, 163, (1, 2, 3), 40), True, True),
              ("exact83", (3, 9, 14, 83, (1, 2, 3, 4), 20), True, True)]
    saved = []
    for name, shape, exact, signed in cases:
        k = cs.cam_case(cam, shape, cs.SEED + sum(shape[:4]), dev,
                        exact=exact, signed_gates=signed)
        saved.append({"name": name, "shape": [*shape[:4], list(shape[4]),
                                              shape[5]],
                      "dils": list(k.pop("dils")),
                      "t": {n: v.cpu() for n, v in k.items()}})
    torch.save(saved, path)
    return [c["name"] for c in saved]


def device_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def breakdown(fn) -> dict:
    """ms of one call by part, and the kernels' names, under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a profile can miss the kernels of its first moments: let those
        # be a spin kernel, finished before fn starts
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    parts, names = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or "spin_kernel" in e.name:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        part = kernel_part(e.name)
        parts[part] = parts.get(part, 0.0) + ms
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + ms
    parts["all_kernels"] = sum(parts.values())
    return {"parts": parts, "kernels": names}


def chain_worker(chain_inputs: str, outs: dict, times: dict) -> None:
    import torch
    from rtpe_tpu_torch.ops import blocks
    dev = torch.device("cuda", 0)
    for case in torch.load(chain_inputs):
        x, w, b = (case["t"][k].to(dev) for k in ("x", "w", "b"))
        got = blocks.basicblock_chain(x, w, b)
        torch.cuda.synchronize()
        outs["basicblock_chain", case["name"]] = [got.cpu()]
        if case["timed"]:
            fn = lambda: blocks.basicblock_chain(x, w, b)    # noqa: E731
            times["basicblock_chain", case["name"]] = {
                "ms": device_ms(fn, reps=20), **breakdown(fn)}
        del x, w, b, got
    torch.cuda.empty_cache()


def worker(root: str, inputs, chain_inputs, save: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from rtpe_tpu_torch.ops import cam
    assert os.path.abspath(cam.__file__).startswith(os.path.abspath(root)), \
        cam.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cases = torch.load(inputs) if inputs else []
    outs, times = {}, {}
    if chain_inputs:
        chain_worker(chain_inputs, outs, times)
    for case in cases:
        t = {n: v.to(dev) for n, v in case["t"].items()}
        dils = tuple(case["dils"])
        for op, keys in OPS.items():
            fn = getattr(cam, op)
            args = [t[k] for k in keys] + [dils]
            got = fn(*args)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            outs[op, case["name"]] = [v.cpu() for v in got]
            if case["name"] in TIMED:
                times[op, case["name"]] = {
                    "ms": device_ms(lambda: fn(*args)),
                    **breakdown(lambda: fn(*args))}
        del t
        torch.cuda.empty_cache()
    torch.save({"outs": outs, "times": times, "file": cam.__file__}, save)


def compare(a, b, names) -> dict:
    import torch
    res = {}
    for n, x, y in zip(names, a, b):
        if torch.equal(x, y):
            res[n] = "equal"
            continue
        scale = max(float(y.float().abs().max()), 1e-30)
        res[n] = float((x.float() - y.float()).abs().max()) / scale
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default="_tree/cam_ab")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--root")
    ap.add_argument("--inputs")
    ap.add_argument("--save")
    ap.add_argument("--chain-inputs")
    ap.add_argument("--only", choices=("cam", "chain"))
    a = ap.parse_args()
    if a.worker:
        worker(a.root, a.inputs, a.chain_inputs, a.save)
        return
    import torch
    os.makedirs(a.out, exist_ok=True)
    inputs = os.path.join(a.out, "inputs.pt")
    chain_inputs = os.path.join(a.out, "chain_inputs.pt")
    args = []
    if a.only != "chain":
        make_inputs(inputs)
        args += ["--inputs", inputs]
    if a.only != "cam":
        make_chain_inputs(chain_inputs)
        args += ["--chain-inputs", chain_inputs]
    turns = [("parent", a.parent), ("new", "."), ("new", "."),
             ("parent", a.parent)]
    runs = []
    for k, (label, root) in enumerate(turns):
        save = os.path.join(a.out, f"{k}_{label}.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--parent", a.parent, "--worker", "--root", root,
                        *args, "--save", save], check=True)
        runs.append(torch.load(save))
    par, new = runs[0], runs[1]
    report = {"files": [r["file"] for r in runs], "ops": {}}
    bad = []
    for (op, case), want in par["outs"].items():
        got = new["outs"][op, case]
        cmp = compare(got, want, OUT_NAMES[op])
        rep_new = all(torch.equal(x, y) for x, y in
                      zip(got, runs[2]["outs"][op, case]))
        rep_par = all(torch.equal(x, y) for x, y in
                      zip(want, runs[3]["outs"][op, case]))
        exact = "exact" in case
        for n, v in cmp.items():
            tol = CHAIN_TOL if op == "basicblock_chain" else (
                SUM_TOL if n in SUMS else None)
            if v != "equal" and (tol is None or v > tol or exact):
                bad.append(f"{op} {case} {n}: {v}")
        if not (rep_new and rep_par):
            bad.append(f"{op} {case}: a tree does not repeat itself")
        report["ops"].setdefault(op, {})[case] = {
            "vs_parent": cmp, "new_repeats": rep_new,
            "parent_repeats": rep_par}
    report["times"] = {
        f"{op} {case}": {
            "ms": [r["times"][op, case]["ms"] for r in runs],
            "ms_by_part": [r["times"][op, case]["parts"] for r in runs],
            "kernels": {lab: runs[i]["times"][op, case]["kernels"]
                        for i, lab in ((0, "parent"), (1, "new"))}}
        for (op, case) in par["times"]}
    report["bad"] = bad
    with open(os.path.join(a.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    short = {k: {"ms": [round(x, 3) for x in v["ms"]],
                 "median_new": statistics.median(v["ms"][1:3])}
             for k, v in report["times"].items()}
    print(json.dumps({"bad": bad, "times": short}))
    print(json.dumps(report))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
