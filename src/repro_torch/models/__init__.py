"""The LM harness's serving path: dense (llama3, stablelm) and SSM
(mamba2) decoders as ``nn.Module``s, with the prefill attention and the
SSD scan on the hand-written kernels."""
