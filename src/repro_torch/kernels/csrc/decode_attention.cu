// decode_attention: single-token GQA attention over a KV cache, with a
// length mask and an online softmax, split across CTAs along the sequence
// (flash-decoding).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py:
// decode_attention (body _decode_attn_kernel), which the JAX package's LM
// decode step computes through its jnp oracle _decode_attention_ref
// (src/repro/models/transformer.py).  Plain twin:
// repro_torch/kernels/decode_attention.py :: decode_attention_plain.
//
// For batch row b and query head i (kv head i / (h / kh)):
//   out[b, i] = softmax_s(q[b, i] . k[b, s, kv] * dh^-0.5, s < length[b])
//               @ v[b, s, kv]
// in float32 whatever the input types (q float32 or bf16, k/v float32 or
// bf16), (b, h, dh) float32 out.  Positions at or past the length are never
// read: a masked score would contribute exp(-1e30 - m) = 0, so skipping
// them is exact.  Every product is a float32 FMA (no TF32, no fast math);
// the result differs from the twin's two-pass softmax only by the order of
// float32 sums and the rescaling of the partial softmaxes.
//
// What bounds it on an H100: each K and V element up to the length is read
// once (2 * length * kh * dh * sizeof(kv) bytes per batch row) and used for
// 2 * group multiply-adds, far below the card's balance point, so the bound
// is bytes: 537 MB, 0.160 ms at 3.35 TB/s, for the decode_32k cut (batch
// 16, 32,768 positions, 2 kv heads of dim 128 in bf16), where one CTA per
// (kv head, batch row) would leave 100 of 132 SMs idle.  Design:
//   * the grid is (splits, kv heads x head chunks, batch rows): the host
//     cuts the sequence into splits of split_len positions (a multiple of
//     the tile) so that the CTAs fill the card once, two an SM (8 splits,
//     256 CTAs at decode_32k: a second, partial wave cost more than the
//     extra CTAs gained); one split when b * kh already fills the card or
//     the length is short;
//   * a CTA streams its split in tiles of 64 positions (32 where shared
//     memory is short) through a ring of 3 (or 2) stages filled with
//     cp.async: tile t + 2's K and V are in flight while tile t is scored
//     and accumulated.  bf16 stays bf16 in shared memory and is converted
//     at use, which halves the footprint, so two CTAs share an SM;
//   * each warp owns 8 positions of every tile and keeps its own online
//     softmax (m, l and acc for up to 8 query heads) in registers: lane l
//     holds acc for dims [l * dpl, (l + 1) * dpl).  With bf16 q and K the
//     8 x 8 scores are 8 mma.sync.m16n8k16 (heads padded to 16 rows, dims
//     in steps of 16): bf16 products are exact in the float32
//     accumulator, so only the order of the sums differs.  Otherwise a
//     score is the warp's sum of its lanes' float32 partial dot products,
//     found for 32 (head, position) pairs at once by a reduce-scatter of
//     five shuffle levels.  p goes through shared memory to the p @ V
//     products, float32 FMAs (p rounded to bf16 would exceed 2e-6);
//   * at the end of its split the CTA merges its 8 warps' partial
//     softmaxes in warp order; with one split it writes the output, else
//     it writes (m, l, acc) to a float32 workspace, and the last CTA of its
//     (batch row, kv head, head chunk) -- an atomic ticket after a
//     __threadfence, reset by that CTA, so no memset launch -- merges the
//     splits in split order.  No float atomics: the result is the same bit
//     for bit from run to run.  An empty partial (a split past its row's
//     ragged length) is m = -1e30, l = 0, acc = 0, never -inf: its merge
//     weight is exp(-1e30 - m_max) = 0, where -inf would give NaN.
// The partial form (decode_attention_partial.cu, its own library built
// beside this one from the same decode_attention.cuh) attends over one block
// of a sequence-split cache: the block holds positions [lo, lo + s) of a
// cache whose valid length is length[b], so the block's own length is
// clamp(length[b] - lo, 0, s), and it writes the block's merged softmax
// beside its output: out = acc / l (0 for an empty block), m_out = m and
// l_out = l, each (b, h) float32.  A block wholly past the length still
// launches and writes the empty-split sentinel (out 0, m -1e30, l 0), which
// takes weight exp(-1e30 - M) * 0 = 0 in the merge across blocks
// (kernels/decode_attention.py :: merge_partials).
// The TPU's sequential s grid with VMEM scratch carried across it becomes
// the in-CTA tile loop plus the cross-CTA merge.

#include "decode_attention.cuh"

// Shared memory one CTA needs, in bytes, for a head dim and cache dtype;
// the wrapper refuses shapes past the card's 227 KB.
extern "C" long long decode_attention_smem_bytes(int dh, int kv_bf16) {
  return make_config(dh, kv_bf16 ? 2 : 4).smem;
}

// The launch's plan for these shapes: out[0..7) = n_splits, split_len,
// head chunks, heads per chunk, tile, stages, CTAs.  max_len is the int
// length, or s for a tensor of lengths.  The workspace the wrapper
// allocates holds b * kh * chunks * n_splits * heads_per_chunk * (dh + 2)
// floats when n_splits > 1, and the ticket array b * kh * chunks zeroed
// ints, which every launch leaves zeroed.
extern "C" void decode_attention_plan(int b, int h, int kh, int dh,
                                      int kv_bf16, int max_len, int* plan) {
  const Config c = make_config(dh, kv_bf16 ? 2 : 4);
  const int group = h / kh;
  const int n_chunks = (group + c.hc - 1) / c.hc;
  int n_splits, split_len;
  make_splits(static_cast<long long>(b) * kh * n_chunks, max_len, c.tile,
              &n_splits, &split_len);
  plan[0] = n_splits;
  plan[1] = split_len;
  plan[2] = n_chunks;
  plan[3] = c.hc;
  plan[4] = c.tile;
  plan[5] = c.stages;
  plan[6] = n_splits * kh * n_chunks * b;
}

// out (b, h, dh) float32 = decode attention of q (b, h, dh) over k, v
// (b, s, kh, dh), all contiguous device memory, scores scaled by scale
// (the wrapper passes dh^-0.5 rounded to float32); q is bf16 when
// q_bf16 != 0 (else float32), k and v bf16 when kv_bf16 != 0.  Batch row r
// attends to positions [0, lengths[r]) or, with lengths == nullptr,
// [0, uniform_len); every length must lie in [1, s] and h % kh == 0,
// dh <= 256 (the wrapper checks).  ws and tickets are as
// decode_attention_plan describes (unused with one split).  Returns
// cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* lengths,
                                       int uniform_len, float* out, float* ws,
                                       int* tickets, int b, int s, int h,
                                       int kh, int dh, float scale,
                                       int q_bf16, int kv_bf16, void* stream) {
  return launch_any<false>(q, k, v, lengths, uniform_len, 0, out, nullptr,
                           nullptr, ws, tickets, b, s, h, kh, dh, scale, q_bf16,
                           kv_bf16, stream);
}
