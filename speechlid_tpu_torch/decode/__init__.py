"""Host-side CTC beam search with n-gram LM fusion and n-gram perplexity
(port of ``speechlid_tpu/decode``), over the repository's C++ library."""

from speechlid_tpu_torch.decode.beam_search import (
    BeamSearchDecoderWithLM,
    NgramLM,
    build_native_library,
)
