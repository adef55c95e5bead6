"""The port's models: the dense GQA decoder-only LM (``transformer.LM``)."""
