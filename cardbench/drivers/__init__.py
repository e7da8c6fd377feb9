"""The general drivers a traffic file's ``kind`` names."""
