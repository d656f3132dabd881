"""One module per kind of cell, named by a traffic file's ``runner``; each
has ``main(run)``."""
