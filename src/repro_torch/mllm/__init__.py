"""Multimodal-LLM compound workload (paper §2.1/§4.1) on the compound
executor: ViT encoder section + LLM backbone section with data-dependent
activation and wavefront-scheduled dispatch.  Counterpart of
``repro/mllm``."""
