"""The actor fleet's wire: the flat frame codec and its connections."""
