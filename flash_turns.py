"""Versions of the tensor-core flash kernel timed in turns within one call.

On the card, from the repository root:

    python3 flash_turns.py [--parent PATH] [--rounds N]

Each version of ``src/repro_torch/kernels/csrc/flash_attention_sm90.cu`` is
built as a library of its own (ptxas's report checked as ``chip_smoke.py``
checks it: 0 spill, no serialized wgmma, HGMMA in the SASS, every instance
present) and held to the plain version at every case of its group on its
first turn; then each case's device time (torch.profiler, the kernel alone)
is taken in turns A B C C B A (``--rounds`` times over), so that versions
are compared on one card within one call.  The versions, each the source with one line rewritten
(written under ``build/flash_turns/``):

- ``change``: the source as it stands;
- ``wide``: D 64 and 128 on the pipeline of D 192 and 256 (a producer
  warpgroup, ``setmaxnreg``, K and V on barriers of their own), 3 stages;
- ``d192s3``: D 192 with 1 Q buffer and 3 stages instead of 2 and 2;
- ``parent`` (with ``--parent``): another version of the source, e.g. an
  earlier commit's unpacked with ``git archive``; D 64 and 128 only.

Prints ``chip_smoke``'s JSON lines; the last is the table of device ms a
turn, by group, version and case.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import chip_smoke as c

SOURCE = c.ROOT / "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"
OUT = c.ROOT / "build" / "flash_turns"
REWRITES = {  # version: (line of the source, its replacement)
    "wide": ("static constexpr bool WIDE = D > 128;",
             "static constexpr bool WIDE = true;"),
    "d192s3": ("STAGES = D <= 128 ? 3 : 2;", "STAGES = D <= 192 ? 3 : 2;"),
}
D192_QBUF = ("QBUF = D <= 192 ? 2 : 1;", "QBUF = D <= 128 ? 2 : 1;")
# group: (versions, cases: name, B, H, Hkv, S, D; bf16, causal)
GROUPS = {
    "D 64/128": (("parent", "change", "wide"),
                 (("granite", c.PROMPTS, 32, 8, c.PROMPT_LEN, 64),
                  ("chatglm3-like", c.PROMPTS, 32, 2, c.PROMPT_LEN, 128))),
    "D 192": (("change", "d192s3"),
              (("nemotron D=192", 1, 96, 8, 1024, 192),
               ("D=192 S=4096", 1, 16, 8, 4096, 192))),
}


def source_of(version, parent) -> pathlib.Path:
    if version == "parent":
        return pathlib.Path(parent).resolve()
    text = SOURCE.read_text()
    pairs = [REWRITES[version]] if version in REWRITES else []
    if version == "d192s3":
        pairs.append(D192_QBUF)
    if not pairs:
        return SOURCE
    for old, new in pairs:
        if text.count(old) != 1:
            raise AssertionError(f"{version}: {old!r} is not in the source "
                                 f"exactly once")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"flash_attention_sm90_{version}.cu"
    path.write_text(text)
    return path


def main() -> int:
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels.cuda_lib import BASE_FLAGS, CudaLibrary
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another flash_attention_sm90.cu")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times over the turns A B C C B A")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_turns: no CUDA device", file=sys.stderr)
        return 2
    c.setup()
    groups = {g: ([v for v in vs if v != "parent" or args.parent], cases)
              for g, (vs, cases) in GROUPS.items()}
    libs = {v: CudaLibrary(f"flash_attention_sm90_{v}",
                           source_of(v, args.parent), BASE_FLAGS,
                           fa._bind_tensor_cores, "flash_sm90_error_string")
            for vs, _ in groups.values() for v in vs}
    with ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.build(), libs.values()))
    for v, lib in libs.items():
        dims = sorted({case[5] for vs, cases in groups.values() if v in vs
                       for case in cases})
        c.tensor_core_report(lib.path(), "HGMMA", c.sm90_flash_instance,
                             [f"DP {d}" for d in dims])
    gen = torch.Generator(device=c.DEVICE).manual_seed(5)
    base = fa.LIBRARIES["tensor_cores"]
    table = {}
    try:
        for g, (versions, cases) in groups.items():
            inputs = {case[0]: c._qkv(gen, *case[1:], torch.bfloat16)
                      for case in cases}
            times = table[g] = {v: {case[0]: [] for case in cases}
                                for v in versions}
            turns = [*versions, *reversed(versions)] * args.rounds
            for turn, v in enumerate(turns):
                fa.LIBRARIES["tensor_cores"] = libs[v]  # this process only
                for what, q_k_v in inputs.items():
                    call = lambda: fa.flash_attention(*q_k_v)  # noqa: E731
                    if turn < len(versions):
                        c._attn_check(call(), tref.attention_ref(*q_k_v),
                                      torch.bfloat16, f"{what} ({v})",
                                      "tensor_cores")
                    times[v][what].append(c.kernel_device_ms(
                        call, "flash_attention_sm90"))
    finally:
        fa.LIBRARIES["tensor_cores"] = base
    c.emit(phase="flash_turns", device_ms=table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
