"""Model side of the port: configs, Llama pieces, compressed linears and the
fused W4A8 prefill and decode steps, and the whole-step megakernel's
decode step."""
