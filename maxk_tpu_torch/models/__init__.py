"""MaxK-SAGE and the flax parameter importer."""
