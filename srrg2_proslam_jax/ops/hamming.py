"""Binary-descriptor Hamming distances as int8 matmuls.

The reference matches 256-bit descriptors with OpenCV Hamming norms inside
scalar loops (brute force: correspondence_finder_descriptor_based_bruteforce_impl.cpp:88-152;
HBST tree for loop closures).  Here the formulation is a matmul: store
each descriptor as 256 signed bits s in {-1, +1} (int8); then for two
descriptors a, b

    dot(a, b) = 256 - 2 * hamming(a, b)   =>   hamming = (256 - dot) / 2.

A full [N, M] distance matrix is one int8 x int8 -> int32 matmul — this
replaces both the brute-force loops and the HBST tree (SURVEY.md §7.2
step 7: on an accelerator a brute-force popcount-matmul beats tree
traversal).

Packed uint32[8] descriptors are also supported for compact storage of
loop-closure databases.
"""
from __future__ import annotations

import jax.numpy as jnp

DESCRIPTOR_BITS = 256
DESCRIPTOR_WORDS = DESCRIPTOR_BITS // 32


def bits_to_signed(bits: jnp.ndarray) -> jnp.ndarray:
    """{0,1} uint8/bool bits [..., 256] -> {-1,+1} int8."""
    return (bits.astype(jnp.int8) * 2 - 1).astype(jnp.int8)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """{0,1} bits [..., 256] -> packed uint32 [..., 8] (little-endian bit order)."""
    b = bits.reshape(bits.shape[:-1] + (DESCRIPTOR_WORDS, 32)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1).astype(jnp.uint32)


def unpack_bits(words: jnp.ndarray) -> jnp.ndarray:
    """Packed uint32 [..., 8] -> {0,1} uint8 bits [..., 256]."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (words[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(words.shape[:-1] + (DESCRIPTOR_BITS,)).astype(jnp.uint8)


def signed_to_bits(signed: jnp.ndarray) -> jnp.ndarray:
    return (signed > 0).astype(jnp.uint8)


def distance_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Hamming distance matrix [N, M] from signed descriptors [N,256],[M,256].

    int8 matmul with int32 accumulation.  Invalid descriptor rows
    (all zeros) yield distance 128 — callers mask with their own validity.
    """
    dot = jnp.matmul(
        desc_a.astype(jnp.int8),
        desc_b.astype(jnp.int8).T,
        preferred_element_type=jnp.int32,
    )
    return (DESCRIPTOR_BITS - dot) // 2


def pairwise_distance(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise Hamming distance between two aligned sets [N, 256] -> [N]."""
    dot = jnp.sum(desc_a.astype(jnp.int32) * desc_b.astype(jnp.int32), axis=-1)
    return (DESCRIPTOR_BITS - dot) // 2
