"""Where ``segment_histogram``'s time goes on the card (kernel row 11b of
the PyTorch/CUDA port): knock-out builds of the kernel timed in turns in
one process, at the bucketed path's two shapes.

    python3 tools/histogram_split.py PARENT

PARENT is a checkout of a tree whose ``reporter_tpu_torch/csrc`` holds the
block-a-row kernel (one 256-thread block a trace row, the output zeroed
by the wrapper's ``torch.zeros``, a compare loop for first occurrence,
four global atomics a point).  The script builds this tree's kernels,
the metro city and the 512 x 64 (seed 7) and 128 x 256 (seed 8) cohorts
of ``chip_smoke.py``, decodes both, holds this tree's histogram against
its plain version, then times with ``chip_smoke.time_ms``'s timer
(queued behind a spin kernel, median of 50 launches), in turns:

  parent: the wrapper (``torch.zeros`` + kernel); ``torch.zeros`` alone;
    the kernel alone on a zeroed output; without the first-occurrence
    test; with every atomic sent to one word; an empty kernel on the
    same grid;
  this tree: the wrapper (zero_output, then the kernel as its
    programmatic dependent); the zeroing alone (the launcher at B = 0);
    the kernel without the zeroing; the zeroing and an ordinary launch
    (no programmatic dependence); a memset and an ordinary launch; the
    kernel without the runs' scan; a trace added at every run start (no
    first-occurrence test); no trace added; blocks of one warp (rows of
    up to 64 points: at 128 x 256 the block-a-row kernel runs); an empty
    kernel on the same grid (no zeroing); zeroing inside the kernel with
    a cooperative grid and one grid barrier in place of zero_output, at
    the kernel's start, or after the three levels of loads (overlapping
    them).

Each knock-out is this tree's or the parent's source with one edit
(``EDITS``), built into build/split/.  A knock-out that does not build
is reported and skipped.  Prints the card's name and power limit and one
``split`` line per shape and build; writes chiprun_out/histogram_split.json.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as CS  # noqa: E402

SRC = "reporter_tpu_torch/csrc/segment_histogram.cu"
ROWS_BODY = "float* __restrict__ out) {\n  __shared__ uint32_t table[kSlots];\n"
COOP_ZERO = (
    "  {  // knock-out: zero the output here, then one grid barrier\n"
    "    const int64_t n = 4 * (int64_t)S, step = (int64_t)gridDim.x * blockDim.x;\n"
    "    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)\n"
    "      out[i] = 0.f;\n"
    "    cooperative_groups::this_grid().sync();\n"
    "  }\n")
LAUNCH = ("    cudaLaunchAttribute dep;\n"
          "    dep.id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
          "    dep.val.programmaticStreamSerializationAllowed = 1;\n"
          "    cudaLaunchConfig_t cfg = {};\n"
          "    cfg.gridDim = dim3((unsigned)(groups < resident ? groups : resident));\n"
          "    cfg.blockDim = dim3(kWarps * 32);\n"
          "    cfg.stream = st;\n"
          "    cfg.attrs = &dep;\n"
          "    cfg.numAttrs = 1;\n"
          "    return (int)cudaLaunchKernelEx(&cfg, histogram_rows, choice, route, cand_edge, "
          "breaks,\n"
          "                                   times, edge_seg, B, T, K, S, wpr, out);\n")
COOP_LAUNCH = (
    "    const unsigned grid = (unsigned)(groups < resident ? groups : resident);\n"
    "    void* args[] = {(void*)&choice, (void*)&route, (void*)&cand_edge, (void*)&breaks,\n"
    "                    (void*)&times, (void*)&edge_seg, (void*)&B, (void*)&T, (void*)&K,\n"
    "                    (void*)&S, (void*)&wpr, (void*)&out};\n"
    "    return (int)cudaLaunchCooperativeKernel((const void*)histogram_rows, dim3(grid),\n"
    "                                            dim3(kWarps * 32), args, 0, st);\n")
ZERO = "  zero_output<<<(unsigned)(zb < 2048 ? zb : 2048), kZeroThreads, 0, st>>>(out, n);\n"
NO_ZERO = (ZERO, "")
TRACE = ("      if (wpr == 1) {\n        if (first[r]) atomicAdd(out + S + sg, 1.f);\n"
         "      } else if (head[r]) {")
LEVEL3 = "      key[r] = sg >= 0 && sg < S ? (uint32_t)sg : kNone;\n    }\n"
COOP_OVERLAP = (
    "    if (g == blockIdx.x) {  // knock-out: the first group zeroes a slice, one grid barrier\n"
    "      const int64_t n = 4 * (int64_t)S, step = (int64_t)gridDim.x * blockDim.x;\n"
    "      for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step)\n"
    "        out[i] = 0.f;\n"
    "      cooperative_groups::this_grid().sync();\n"
    "    }\n")
COOP_INCLUDE = ('#include "common.cuh"\n',
                '#include "common.cuh"\n\n#include <cooperative_groups.h>\n')
ORDINARY = ("    cfg.numAttrs = 1;\n", "    cfg.numAttrs = 0;\n")

# (tree, tag): [(old, new), ...], each old found exactly once
EDITS = {
    ("parent", "no_first"): [
        ("    for (int u = 0; u < t && first; ++u) first = seg[u] != sg;\n", "")],
    ("parent", "one_word"): [
        ("atomicAdd(point_count + sg,", "atomicAdd(out,"),
        ("atomicAdd(trace_count + sg,", "atomicAdd(out,"),
        ("atomicAdd(time_in + sg,", "atomicAdd(out,"),
        ("atomicAdd(dist_in + sg,", "atomicAdd(out,")],
    ("parent", "empty"): [
        ("float* __restrict__ out) {\n  extern __shared__",
         "float* __restrict__ out) {\n  return;\n  extern __shared__")],
    ("change", "no_zeroing"): [NO_ZERO],
    ("change", "no_pdl"): [ORDINARY],
    ("change", "memset"): [(ZERO, "  cudaMemsetAsync(out, 0, n * sizeof(float), st);\n"),
                           ORDINARY],
    ("change", "no_scan"): [NO_ZERO, ("for (int d = 1; d < 32; d <<= 1) {",
                                      "for (int d = 32; d < 32; d <<= 1) {")],
    ("change", "no_dedup"): [NO_ZERO, (TRACE, "      if (head[r]) {\n"
                                              "        atomicAdd(out + S + sg, 1.f);\n"
                                              "      }\n      if (false) {")],
    ("change", "no_trace"): [NO_ZERO, (TRACE, "      if (false) {")],
    ("change", "one_warp_blocks"): [NO_ZERO,
                                    ("constexpr int kWarps = 4; ", "constexpr int kWarps = 1; ")],
    ("change", "empty"): [NO_ZERO, (ROWS_BODY, ROWS_BODY.replace("{\n", "{\n  return;\n", 1))],
    ("change", "coop_zero"): [NO_ZERO, COOP_INCLUDE, (ROWS_BODY, ROWS_BODY + COOP_ZERO),
                              (LAUNCH, COOP_LAUNCH)],
    ("change", "coop_overlap"): [NO_ZERO, COOP_INCLUDE, (LEVEL3, LEVEL3 + COOP_OVERLAP),
                                 (LAUNCH, COOP_LAUNCH)],
}


def knockout_tree(tree, tag, edits):
    """build/split/<tag>/ holding ``tree``'s csrc headers and its
    segment_histogram.cu with ``edits`` made."""
    root = os.path.join(REPO, "build", "split", tag)
    csrc = os.path.join(root, "reporter_tpu_torch", "csrc")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(csrc)
    src_dir = os.path.join(tree, "reporter_tpu_torch", "csrc")
    for name in os.listdir(src_dir):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, name), csrc)
    with open(os.path.join(tree, SRC)) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError("%s: edit anchor found %d times: %r" % (tag, text.count(old), old))
        text = text.replace(old, new)
    with open(os.path.join(root, SRC), "w") as f:
        f.write(text)
    return root


def main(parent, matcher=None):
    """Times the knock-outs against ``parent`` on the metro city (``matcher``
    when given, else built here)."""
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("histogram_split: CUDA is not available\n")
        return 2
    from reporter_tpu_torch.ops import histogram as Hg
    from reporter_tpu_torch.ops import viterbi as V
    from reporter_tpu_torch.ops._kernels import KERNELS, ptr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    device = torch.device("cuda", torch.cuda.current_device())
    CS.build()
    trees = {"parent": os.path.abspath(parent), "change": REPO}
    builds = {"parent": CS.parent_kernels(trees["parent"], "split_parent")[0]}
    for (tree, tag), edits in EDITS.items():
        name = "%s_%s" % (tree, tag)
        try:
            builds[name] = CS.parent_kernels(knockout_tree(trees[tree], name, edits), name)[0]
        except Exception as e:  # a knock-out that does not build is reported, not timed
            print("split %s: did not build (%s)" % (name, str(e).splitlines()[-1][:200]))
    floor = CS.launch_floor(smi.splitlines()[0])
    if matcher is None:
        matcher, _city = CS.metro_city(120, device)
    S = len(matcher.arrays.seg_ids)
    dg, du, p, K = matcher._dg, matcher._du, matcher._params, matcher.cfg.beam_k
    out = {"card": smi, "floor_ms": floor, "shapes": {}}
    for seed, n, T in ((7, 512, 64), (8, 128, 256)):
        xin = CS.bucket_rows(matcher, CS.cohort(matcher, seed, n, T), T)
        x, y, t, v = V.unpack_inputs(xin)
        pre, packed, _aux, choice = V.match_batch_full(dg, du, x, y, t, v, p, K)
        hargs = (choice, pre.route, pre.cand.edge, packed[2], t, dg.edge_seg, S)
        got, want = Hg.segment_histogram(*hargs), Hg.segment_histogram_plain(*hargs)
        CS.check(CS._hist_same(got, want), "segment_histogram %dx%d equals its plain version"
                 % (n, T))
        zeroed = torch.zeros((4, S), dtype=torch.float32, device=device)
        raw = [ptr(a) for a in hargs[:6]]

        def launch(k, rows=n, dst=zeroed):
            return lambda: k.launch(device, *raw, rows, T, K, S, ptr(dst))

        calls = {
            "parent: wrapper (torch.zeros + kernel)": (
                "parent", lambda: Hg.segment_histogram(*hargs)),
            "parent: torch.zeros alone": (None, lambda: torch.zeros((4, S), dtype=torch.float32,
                                                                    device=device)),
            "parent: kernel alone": (None, launch(builds["parent"]["segment_histogram"])),
            "this tree: wrapper (zeroing + kernel)": (None, lambda: Hg.segment_histogram(*hargs)),
            "this tree: zeroing alone (B = 0)": (None, launch(KERNELS["segment_histogram"], 0)),
        }
        for name, ks in builds.items():
            if name != "parent":
                calls[name.replace("_", ": ", 1)] = (None, launch(ks["segment_histogram"]))
        order = list(calls)
        times = {k: [] for k in order}
        for turn in (order, order[::-1]):
            for name in turn:
                tree, fn = calls[name]
                with CS.design(builds[tree] if tree else {}):
                    times[name].append(CS._median_ms(fn, reps=50, warmup=3, cold_l2=False,
                                                     queued=True, prep=None))
        shape = "%dx%d S=%d" % (n, T, S)
        for name in order:
            print("split %-12s %-48s %s  mean %.4f" % (
                shape, name, " ".join("%.4f" % x for x in times[name]),
                statistics.mean(times[name])))
        out["shapes"][shape] = times
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "histogram_split.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
