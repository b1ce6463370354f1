"""Model families. The recsys family is ported (fm, dlrm-rm2, xdeepfm,
bert4rec and the STABLE retrieval head), for serving and training; the LM
and GNN families come with their ROADMAP.md item."""
