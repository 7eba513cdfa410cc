"""Model configs, blocks and stage assembly of the port."""
