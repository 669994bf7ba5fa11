"""Dataset registry, seeded synthetic graphs and the binary graph format."""
