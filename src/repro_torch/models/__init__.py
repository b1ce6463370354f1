"""Model families. The recsys family is ported for serving (fm, dlrm-rm2,
xdeepfm, bert4rec and the STABLE retrieval head); training and the LM and
GNN families come with their ROADMAP.md items."""
