"""The native C++ stereo loader (:mod:`.native`, ``stereo_loader.cc``)."""
