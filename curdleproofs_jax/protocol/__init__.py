"""Protocol layer: the Curdleproofs shuffle argument, vector-first.

Every sub-argument is written against the batched `ScalarVec` / `PointVec`
value types (curdleproofs_jax.vectors) so each O(n) operation is a single
dispatch into the device engines or the native host backend, and all wire
formats come from one declarative codec (protocol.wire).

Modules:
  wire        declarative byte/JSON codec shared by every proof type
  primitives  Pedersen group commitments, the CRS, the deferred-MSM batcher
  folding     Bulletproofs-style folding arguments (IPA, same-MSM)
  products    grand-product and same-permutation arguments
  sigma       Sigma-protocols (same-scalar, tracker opening)
  shuffle     the top-level shuffle argument
  whisk       Ethereum Whisk byte-level consensus API
"""
