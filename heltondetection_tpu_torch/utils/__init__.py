"""Weight bridge from the reference package's flax variables."""
