"""Host-side native code: the C++ tokenizer encoder, built with the host's
C++ compiler on first use."""
