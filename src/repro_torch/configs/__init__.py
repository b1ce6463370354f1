"""Architecture configs. The four recsys configs are ported; the registry
names the ROADMAP item of every LM and GNN id of the reference."""
