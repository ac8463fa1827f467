"""The entry points a traffic file drives, one module each, found by the
traffic file's ``entry``: each module's ``Entry`` builds the port's state,
feeds it batches through the port's own feed, runs the window and reads the
cell's end-to-end metrics by name, and runs the matching plain reference."""
