"""Architecture configs. The five LM configs and the four recsys configs are
ported; the registry names the ROADMAP item of the reference's GNN id."""
