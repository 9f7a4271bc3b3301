"""Model families of the torch port."""
