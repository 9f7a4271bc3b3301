"""Generation pieces the serving path uses: sampling, KV write/attend plans, the generation config."""
