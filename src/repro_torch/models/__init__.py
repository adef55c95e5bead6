"""The port's models: the decoder-only LM (``transformer.LM``: dense GQA,
DeepSeekMoE, MLA) and its MoE layer (``moe``)."""
