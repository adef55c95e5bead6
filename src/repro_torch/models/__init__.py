"""The port's models: the decoder-only LM (``transformer.LM``: dense GQA,
DeepSeekMoE, MLA), its MoE layer (``moe``) and the GNN family (``gnn``)."""
