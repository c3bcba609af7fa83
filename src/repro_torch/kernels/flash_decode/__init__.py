"""Quantized-KV flash attention: flat and paged decode, chunked-prefill
extend (``ops``), their plain versions (``ref``) and CUDA launchers
(``kernel``)."""
