// decode_attention_partial: the decode-attention kernel's partial form over
// one kv_seq block of a sequence-split cache (decode_attention.cuh; the
// design, and the partial form's contract, in decode_attention.cu).
//
// Replaces, with decode_attention.cu, the Pallas TPU kernel of
// src/repro/kernels/decode_attention.py: decode_attention (body
// _decode_attn_kernel), here over one block of a cache whose kv_seq dim is
// split over 'model' shards, where the JAX package's GSPMD splits the
// decode step's jnp attention (_decode_attention_ref,
// src/repro/models/transformer.py).  Plain twin:
// repro_torch/kernels/decode_attention.py :: decode_attention_partial_plain;
// the blocks' merge: merge_partials there.

#include "decode_attention.cuh"

// The partial form: k, v (b, s, kh, dh) hold positions [lo, lo + s) of a
// cache whose row r has valid length lengths[r] (or uniform_len), any value
// >= 0; the block's row attends to its clamp(length - lo, 0, s) positions.
// Writes out (b, h, dh) = acc / l (0 for an empty row), m_out and l_out
// (b, h): the block's max score and sum of exp(score - m), -1e30 and 0 for
// an empty row.  ws and tickets as for decode_attention_launch, planned
// with max_len = the block's own uniform length (at least 1), or s for a
// lengths array.  Returns cudaGetLastError().
extern "C" int decode_attention_partial_launch(
    const void* q, const void* k, const void* v, const int* lengths,
    int uniform_len, int lo, float* out, float* m_out, float* l_out, float* ws,
    int* tickets, int b, int s, int h, int kh, int dh, float scale, int q_bf16,
    int kv_bf16, void* stream) {
  if (m_out == nullptr || l_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_any<true>(q, k, v, lengths, uniform_len, lo, out, m_out, l_out,
                          ws, tickets, b, s, h, kh, dh, scale, q_bf16, kv_bf16,
                          stream);
}
