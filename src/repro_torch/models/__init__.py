"""Model families, all ported: recsys (fm, dlrm-rm2, xdeepfm, bert4rec and
the STABLE retrieval head; ``recsys.py``), LM (``transformer.py``) and GNN
(``gnn.py``), each for serving and training."""
