"""Plain PyTorch references, one module a model, named by a configuration's
`reference` key. They import nothing of the program under test."""
