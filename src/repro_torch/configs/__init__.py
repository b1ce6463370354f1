"""Architecture configs. Only the ``fm`` recsys config is ported; the
registry names the ROADMAP item of every other id of the reference."""
