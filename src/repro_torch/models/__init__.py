"""Model families. The recsys family's fm model is ported (serving and the
STABLE retrieval head); the others come with their ROADMAP.md items."""
