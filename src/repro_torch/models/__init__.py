"""The port's models: the decoder-only LM (``transformer.LM``: dense GQA,
DeepSeekMoE, MLA), its MoE layer (``moe``), the GNN family (``gnn``) and
the recsys family (``recsys``: the embedding bags, AutoInt)."""
