"""Core numerics: chunked FFT, sparsification, packing, quantizer, selection,
and the compressor protocol."""
