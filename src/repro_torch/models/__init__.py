"""The LM harness's serving path: decoder-only models as ``nn.Module``s,
for the dense (llama3, stablelm, granite, internlm2), moe (granite-moe,
llama4-scout), hybrid (jamba), ssm (mamba2) and vlm (qwen2-vl) families,
with the prefill attention and the SSD scan on the hand-written kernels;
the MoE's routing, dispatch and expert products are plain torch, as the
reference's are plain jnp."""
