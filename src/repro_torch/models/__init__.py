"""Language models of the reference's side-stack, dense family."""
