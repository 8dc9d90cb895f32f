#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``autodist_tpu_torch/kernel/csrc``
(at first use, into a git-ignored directory) and drives the serving
path of the pipelined LM at the serve bench's width (vocab 32768,
hidden 1024, 16 heads of 64, mlp 4096, 8 layers, max_len 1024):

1. each kernel against its plain PyTorch version at the serving shapes,
   fp32 (atol = rtol = 1e-5) and bf16 (atol = rtol = 1e-2), timed with
   CUDA events beside the plain version, one PyTorch library call and
   the card's bound;
2. fp32 parity: 4 requests through ``ContinuousBatcher`` on the dense
   and on the paged + chunked engine, each stream equal token for token
   to a greedy full recompute by ``sequential_logits`` (a divergence
   counts as a tie only where the reference's top two logits are within
   1e-4);
3. bf16 serving of the bench mix on both engines, with the kernels'
   launch counters held to the attention calls the engines made;
4. one ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Any failed check raises and the script exits non-zero; without a CUDA
device it exits 2 and prints no result.  Imports torch, numpy and
``autodist_tpu_torch`` only.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch.kernel import flash_decode as fd
from autodist_tpu_torch.kernel import flash_prefill as fp
from autodist_tpu_torch.models.pipeline_lm import sequential_logits
from autodist_tpu_torch.serving import FINISH_REASONS, kv_cache

# Published H100 SXM rates (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

VOCAB, HIDDEN, LAYERS, HEADS, MLP, MAX_LEN = 32768, 1024, 8, 16, 4096, 1024
HEAD_DIM = HIDDEN // HEADS
BLOCK_LEN, NUM_BLOCKS, CHUNK = 16, 512, 64
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # atol = rtol

KERNELS = {
    "flash_decode": dict(
        wrapper=fd.flash_decode_attention,
        source="autodist_tpu_torch/kernel/csrc/flash_decode.cu",
        replaces="autodist_tpu/kernel/pallas/flash_decode.py:45"),
    "flash_decode_paged": dict(
        wrapper=fd.flash_decode_attention_paged,
        source="autodist_tpu_torch/kernel/csrc/flash_decode.cu",
        replaces="autodist_tpu/kernel/pallas/flash_decode.py:148"),
    "flash_prefill_paged": dict(
        wrapper=fp.flash_prefill_attention_paged,
        source="autodist_tpu_torch/kernel/csrc/flash_prefill.cu",
        replaces="autodist_tpu/kernel/pallas/flash_prefill.py:48"),
}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reset_launches():
    for k in KERNELS.values():
        k["wrapper"].launches = 0


def launches():
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def cfg_of(dtype):
    return port.TransformerConfig(
        vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
        num_heads=HEADS, mlp_dim=MLP, max_len=MAX_LEN, dtype=dtype,
        dropout_rate=0.0, attention_dropout_rate=0.0)


# --------------------------------------------------------------------- #
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------- #
def edge_values(n, hi, rng):
    """0, 15, 16, 17, 1023 (block and tile edges), then random."""
    vals = [0, 15, 16, 17, MAX_LEN - 1]
    return np.array(vals + list(rng.randint(0, hi, n - len(vals))), np.int32)


def tail_filled_table(spans, rng):
    """Block table rows as ``reserve_slot`` lays them out: each slot's
    blocks drawn from one shuffled pool, the row tail-filled with its
    last block."""
    mb = MAX_LEN // BLOCK_LEN
    free = list(rng.permutation(NUM_BLOCKS))
    table = np.zeros((len(spans), mb), np.int32)
    for i, span in enumerate(spans):
        n = kv_cache.blocks_for(max(int(span), 1), BLOCK_LEN)
        blocks = [free.pop() for _ in range(n)]
        table[i, :] = blocks[-1]
        table[i, :n] = blocks
    return table


def kernel_cases(dtype, gen, rng):
    """(name, args, kwargs, bytes, flops) at the serving shapes."""
    dev = "cuda"
    esize = torch.empty((), dtype=dtype).element_size()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    mb = MAX_LEN // BLOCK_LEN
    cases = []
    # K5: 8 slots over dense lanes.
    lengths = edge_values(8, MAX_LEN, rng)
    n_vis = np.minimum(lengths.astype(np.int64) + 1, MAX_LEN)
    args = (randn(8, 1, HEADS, HEAD_DIM), randn(8, HEADS, MAX_LEN, HEAD_DIM),
            randn(8, HEADS, MAX_LEN, HEAD_DIM),
            torch.as_tensor(lengths, device=dev))
    kv_bytes = 2 * n_vis.sum() * HEADS * HEAD_DIM * esize
    cases.append(("flash_decode", args, {},
                  kv_bytes + 2 * 8 * HEADS * HEAD_DIM * esize + 8 * 4,
                  4 * HEAD_DIM * HEADS * n_vis.sum()))
    # K6: 32 slots over the 512-block pool.
    k_pool = randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM)
    v_pool = randn(NUM_BLOCKS, HEADS, BLOCK_LEN, HEAD_DIM)
    lengths = edge_values(32, 200, rng)
    n_vis = lengths.astype(np.int64) + 1
    table = tail_filled_table(n_vis, rng)
    args = (randn(32, 1, HEADS, HEAD_DIM), k_pool, v_pool,
            torch.as_tensor(lengths, device=dev),
            torch.as_tensor(table, device=dev))
    kv_bytes = 2 * n_vis.sum() * HEADS * HEAD_DIM * esize
    tab_bytes = 4 * sum(kv_cache.blocks_for(n, BLOCK_LEN) for n in n_vis)
    cases.append(("flash_decode_paged", args, {"block_len": BLOCK_LEN},
                  kv_bytes + 2 * 32 * HEADS * HEAD_DIM * esize + 32 * 4
                  + tab_bytes, 4 * HEAD_DIM * HEADS * n_vis.sum()))
    # K7: a 64-row chunk for each of 32 slots over the same pool.
    starts = edge_values(32, 150, rng)
    n_keys = np.minimum(starts.astype(np.int64) + CHUNK, mb * BLOCK_LEN)
    table = tail_filled_table(n_keys, rng)
    args = (randn(32, CHUNK, HEADS, HEAD_DIM), k_pool, v_pool,
            torch.as_tensor(starts, device=dev),
            torch.as_tensor(table, device=dev))
    rows = np.minimum(starts[:, None].astype(np.int64) + np.arange(CHUNK) + 1,
                      mb * BLOCK_LEN)
    kv_bytes = 2 * n_keys.sum() * HEADS * HEAD_DIM * esize
    tab_bytes = 4 * sum(kv_cache.blocks_for(n, BLOCK_LEN) for n in n_keys)
    cases.append(("flash_prefill_paged", args, {"block_len": BLOCK_LEN},
                  kv_bytes + 2 * 32 * CHUNK * HEADS * HEAD_DIM * esize
                  + 32 * 4 + tab_bytes, 4 * HEAD_DIM * HEADS * rows.sum()))
    return cases


def library_call(name, args, block_len=None):
    """One PyTorch call computing the same function (timed as a
    yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    if name == "flash_decode":
        q, k, v, lengths = args
        rows = lengths[:, None]                        # one query row
    else:
        q, k_pool, v_pool, idx, table = args
        k = kv_cache.gather_blocks(k_pool, table)
        v = kv_cache.gather_blocks(v_pool, table)
        C = q.shape[1]
        rows = idx[:, None] + torch.arange(C, device=q.device)
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, None, :] <= rows[:, :, None])[:, None]  # [B,1,C,T]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                         attn_mask=mask)
    return out.transpose(1, 2)


def time_ms(fn, reps=30):
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events
    around the call only.  The 50 MB L2 is flushed before each call by
    reading 64 MB (the serving loop reaches each layer's cache cold; a
    read leaves no dirty lines to write back inside the timed call).  A
    spin kernel holds the card while the host enqueues every call, so
    the events time the device and not the host's launch overhead."""
    flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(300_000_000)            # ~0.2 s at H100 clocks
    for e0, e1 in events:
        flush.sum()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps


def phase_kernels():
    """Kernel vs plain at both dtypes; returns the per-kernel record."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOLERANCE[dtype]
        for name, args, kw, nbytes, flops in kernel_cases(dtype, gen, rng):
            wrapper = KERNELS[name]["wrapper"]
            plain = {"flash_decode": fd.flash_decode_attention_plain,
                     "flash_decode_paged":
                         fd.flash_decode_attention_paged_plain,
                     "flash_prefill_paged":
                         fp.flash_prefill_attention_paged_plain}[name]
            got = wrapper(*args, dtype=dtype, **kw)
            ref = plain(*args, dtype=dtype, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            max_err = float(err.max())
            check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            check(bool((err <= tol + tol * ref.float().abs()).all()),
                  f"{name} {dtype}: max |kernel - plain| = {max_err} "
                  f"exceeds atol = rtol = {tol}")
            peak = PEAK_FLOPS[dtype]
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
            rec = {
                "max_abs_err": max_err,
                "ms": time_ms(lambda: wrapper(*args, dtype=dtype, **kw)),
                "plain_ms": time_ms(lambda: plain(*args, dtype=dtype, **kw)),
                "library_ms": time_ms(lambda: library_call(name, args)),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            print(f"phase 1 {name} {str(dtype)[6:]}: max_abs_err "
                  f"{max_err:.3e} (tol {tol}), kernel {rec['ms']:.4f} ms, "
                  f"plain {rec['plain_ms']:.4f} ms, library "
                  f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f}"
                  f" ms ({rec['bound_by']})", flush=True)
            record[(name, dtype)] = rec
    return record


# --------------------------------------------------------------------- #
# phase 2: fp32 parity against the greedy full recompute
# --------------------------------------------------------------------- #
def count_calls(engine):
    """Wrap the engine so the phase can count decode windows and
    prefill chunks (the attention calls it made)."""
    calls = {"windows": 0, "chunks": 0}
    decode_window, prefill = engine.decode_window, engine.prefill

    def counted_window(active):
        calls["windows"] += 1
        return decode_window(active)

    def counted_prefill(*a, **kw):
        out = prefill(*a, **kw)
        calls["chunks"] += engine.last_prefill_chunks
        return out

    engine.decode_window, engine.prefill = counted_window, counted_prefill
    return calls


ENGINES = {
    "dense": dict(num_slots=8, decode_steps=16, prefill_len=64),
    "paged": dict(num_slots=32, decode_steps=16, prefill_len=64,
                  kv_layout="paged", kv_block_len=BLOCK_LEN,
                  kv_num_blocks=NUM_BLOCKS, prefill_chunk=CHUNK),
}


def phase_parity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_of(torch.float32)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    rng = np.random.RandomState(1)
    ties = 0
    for layout, max_prompt in (("dense", 64), ("paged", 200)):
        engine = port.serve(cfg, params=params, device="cuda",
                            **ENGINES[layout])
        batcher = port.ContinuousBatcher(engine)
        prompts = [rng.randint(0, VOCAB, int(n)).tolist()
                   for n in [1, max_prompt] + list(
                       rng.randint(1, max_prompt + 1, 2))]
        rids = [batcher.submit(p, max_new_tokens=40) for p in prompts]
        done = batcher.run()
        compared = 0
        for p, rid in zip(prompts, rids):
            gen = done[rid].tokens
            seq = torch.as_tensor([p + gen[:-1]], device="cuda")
            logits = sequential_logits(cfg, params, seq)[0, len(p) - 1:]
            want = logits.argmax(-1).tolist()
            for i, tok in enumerate(gen):
                if tok == want[i]:
                    compared += 1
                    continue
                top2 = logits[i].topk(2).values
                gap = float(top2[0] - top2[1])
                check(gap < 1e-4, f"{layout} {rid}: token {i} is {tok}, "
                      f"the recompute gives {want[i]} (top-2 gap {gap})")
                ties += 1
                break
        check(engine.block_accounting()[1] == 0, "blocks leaked")
        print(f"phase 2 {layout}: {compared} tokens equal to the greedy "
              f"recompute over {len(prompts)} requests", flush=True)
    print(f"phase 2 ties: {ties}", flush=True)
    del params
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 3: bf16 serving of the bench mix
# --------------------------------------------------------------------- #
def profile_window(engine, n_active):
    """Where one decode window's time goes: its host wall time (timed
    without the profiler), the device time of the kernels
    ``torch.profiler`` records in a second window, and the top kernels.
    Prints "not measured" where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    active = np.zeros(engine.num_slots, bool)
    active[:n_active] = True
    engine.decode_window(active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_window(active)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.decode_window(active)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        print("phase 3 window profile: device time not measured")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    syncs = sum(e.count for e in kernels if e.key.startswith("Memcpy DtoH"))
    print(f"phase 3 window profile: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), "
          f"{sum(e.count for e in kernels)} kernel launches, {syncs} "
          f"device-to-host copies; top: " + "; ".join(
              f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
              for e in top), flush=True)


def phase_serve():
    cfg = cfg_of(torch.bfloat16)
    params = port.init_pipeline_lm_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    counts = {}
    for layout in ("dense", "paged"):
        engine = port.serve(cfg, params=params, device="cuda",
                            **ENGINES[layout])
        batcher = port.ContinuousBatcher(engine)
        rng = np.random.RandomState(0)
        batcher.submit(rng.randint(0, VOCAB, 4).tolist(), max_new_tokens=16)
        batcher.run()                                   # warm-up
        calls = count_calls(engine)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [batcher.submit(
            rng.randint(0, VOCAB, int(rng.randint(1, 65))).tolist(),
            max_new_tokens=128) for _ in range(16)]
        done = batcher.run()
        wall = time.perf_counter() - t0
        got = launches()
        comps = [done[r] for r in rids]
        check(all(c.finish_reason in FINISH_REASONS for c in comps),
              "invalid finish reason")
        check(all(0 <= t < VOCAB for c in comps for t in c.tokens),
              "token outside the vocabulary")
        free, used, total = engine.block_accounting()
        check(used == 0 and free == total, f"blocks leaked: {free, used}")
        per_window = LAYERS * engine.decode_steps
        want = ({"flash_decode": per_window * calls["windows"],
                 "flash_decode_paged": 0, "flash_prefill_paged": 0}
                if layout == "dense" else
                {"flash_decode": 0,
                 "flash_decode_paged": per_window * calls["windows"],
                 "flash_prefill_paged": LAYERS * calls["chunks"]})
        check(got == want, f"{layout}: launches {got}, attention calls "
              f"{want}")
        check(all(n > 0 for n in want.values() if n != 0)
              and sum(n > 0 for n in got.values()) == (1 if layout == "dense"
                                                       else 2),
              f"{layout}: a kernel of the path was never launched: {got}")
        tokens = sum(len(c.tokens) for c in comps)
        itl = [ms for c in comps for ms in c.inter_token_ms]
        ttft = sorted(c.ttft_s * 1e3 for c in comps)
        print(f"phase 3 {layout} bf16: {tokens} tokens in {wall:.3f} s = "
              f"{tokens / wall:.1f} tokens/s, TTFT p50 "
              f"{ttft[len(ttft) // 2]:.2f} ms, inter-token p50 "
              f"{np.percentile(itl, 50):.3f} ms p99 "
              f"{np.percentile(itl, 99):.3f} ms, windows "
              f"{calls['windows']}, chunks {calls['chunks']}, launches "
              f"{got}", flush=True)
        counts.update({k: v for k, v in got.items() if v})
        profile_window(engine, min(16, engine.num_slots))
        del engine, batcher
        torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    record = phase_kernels()
    print(f"phase 1 done at {time.perf_counter() - t0:.1f} s", flush=True)
    phase_parity()
    print(f"phase 2 done at {time.perf_counter() - t0:.1f} s", flush=True)
    counts = phase_serve()
    print(f"phase 3 done at {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = []
    for name, k in KERNELS.items():
        rec = record[(name, torch.bfloat16)]
        kernels.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": counts[name],
            "max_abs_err": rec["max_abs_err"],
            "max_abs_err_fp32": record[(name, torch.float32)]["max_abs_err"],
            "ms": rec["ms"], "kernel_ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "dtype": "bfloat16"})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
