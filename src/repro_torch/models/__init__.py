"""Model families. The recsys family is ported (fm, dlrm-rm2, xdeepfm,
bert4rec and the STABLE retrieval head), for serving and training; the LM
family (``transformer.py``) for serving; the GNN family comes with its
ROADMAP.md item."""
